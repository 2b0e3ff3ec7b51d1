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

The static tables are host numpy (as in the JAX package) or f32 tensors
computed once on the CPU and copied to each device at first use; the
static norms are computed once per (plan, device). The unfused sweep,
``project_fast`` and ``_inverse_rebin`` are ported with a later slice.
Output orientation matches ``fbp_convert_fast``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ipdm_tpu_torch.ops.cuda.shift import (anterp_taps,
                                           bp_shift_accumulate_batched,
                                           fp_plane_deposit, os_sart_sweep)
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
    """Static tables of one view group (sart_fast.py:95-203) on the Kf=1
    fine grid: fine ray m sits at t position sgn·(step·m + β0), with step
    the view's per-row advance, and a row deposit is a contiguous width-n
    window of the [L] fine layout.

    ``ids`` are global view indices (they pick the angles); ``local_ids``
    the rows of the folded, subsampled parallel sinogram."""

    def __init__(self, p: _FastPlan, ids: np.ndarray, local_ids: np.ndarray,
                 xdrive: bool):
        self.p = p
        self.local_ids = local_ids
        self.xdrive = xdrive
        self.V = len(ids)
        self.Vpad = _round_up(max(self.V, 1), VB)
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
        step = np.abs(a)                                       # [V]
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
        # Lq fine rays, sized so every deposit/read window stays inside
        self.Wn = _round_up(n, 128)
        o_hi = int(np.floor(o_real).max() + 1 if self.V else 0)
        self.Lq = o_hi + self.Wn + 132
        self.L = _round_up(self.Lq + 128, 128)
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
        row y of view v deposits at o = (sgn·b(y, v) − β0_v)/step_v with
        b = other_y·ob_v + c0_v, in f32 as the JAX plan computes it."""
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
        live = self._live()
        zero = torch.zeros((), dtype=torch.int32)
        return (torch.where(live, oi, zero),
                torch.where(live, oi + 1, zero).clamp(0, smax),
                torch.where(live, frac, torch.zeros(())))

    def _qpos(self, m: torch.Tensor) -> torch.Tensor:
        """t positions sgn·(step·m + β0) of fine rays m [M]: [Vpad, M]."""
        sgn = self._pad_vec(self.sgn)[:, None]
        step = self._pad_vec(self.step, fill=1.0)[:, None]
        beta0 = self._pad_vec(self.beta0)[:, None]
        return sgn * (step * m[None, :].float() + beta0)

    def _valid_table(self):
        """qvalid f32 [Vpad, L] (sart_fast.py:182-203): the fine rays that
        land inside the t grid; pad rows and the tail past Lq are dead."""
        f = torch.arange(self.L, dtype=torch.int32)
        qpos = self._qpos(f)
        return ((qpos >= 0.0) & (qpos <= self.p.Nt - 1)
                & (f < self.Lq)[None, :] & self._live()).float()

    def _resample_tables(self):
        """The two taps of the t → fine resample (sart_fast.py:417-438):
        qi [Vpad, Lq] int32 and W [Vpad, 2, Lq], where a second tap
        clipped onto the first folds into it (w0 = (1−qf) + qf·same), the
        clipped lerp exactly."""
        Nt = self.p.Nt
        qpos = self._qpos(torch.arange(self.Lq, dtype=torch.int32))
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
    (sart_fast.py:206-355) on the Kf=1 fine grid (fine ray spacing = the
    view's per-row advance), the one the fused sweep runs on."""

    def __init__(self, g: FBPGeometry, nsubsets: int,
                 view_ids: np.ndarray = None):
        self.g = g
        self.p = _plan_for(g, oversample=1.0)
        p = self.p
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
        self.gx_all = _Group(p, self.view_ids[m], loc_all[m], True)
        self.gy_all = _Group(p, self.view_ids[~m], loc_all[~m], False)
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

    def fp_group_fine(self, img: torch.Tensor, grp: _Group) -> torch.Tensor:
        """FP of one group onto its fine grid (sart_fast.py:285-302).
        img [B, n, n] (fbp frame). Returns [Vpad, B, L] ray sums in
        deposit units."""
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
        return fp_plane_deposit(rows, tb["s0"], tb["s1"], w0.contiguous(),
                                w1.contiguous(), grp.L)

    def fp_group(self, img: torch.Tensor, grp: _Group) -> torch.Tensor:
        """FP of one group onto the t bins (sart_fast.py:304-355, the
        anterpolation branch at Kf=1): the fine ray sums resampled by
        :func:`anterp_taps` with 4 linear taps. img [B, n, n]. Returns
        [B, V, Nt]."""
        p = self.p
        B = img.shape[0]
        dev = img.device
        if grp.V == 0:
            return img.new_zeros((B, 0, p.Nt))
        Wt = 4
        T = self.fp_group_fine(img, grp)[:grp.V, :, :grp.Lq]  # [V, B, Lq]
        d = torch.arange(p.Nt, dtype=torch.float32, device=dev)[None, :]
        f32 = lambda a: torch.as_tensor(a, device=dev)[:, None]
        sgn, step, beta0 = f32(grp.sgn), f32(grp.step), f32(grp.beta0)
        d_adj = torch.where(sgn > 0, d, -d)
        m0 = torch.floor((d_adj - 1.0 - beta0) / step).to(torch.int32)
        qi0 = m0.clamp(0, max(grp.Lq - 1, 0))                  # [V, Nt]
        ks = torch.arange(Wt, dtype=torch.float32, device=dev)[None, :, None]
        midx = qi0[:, None, :].float() + ks                    # [V, Wt, Nt]
        qpos = sgn[:, None] * (step[:, None] * midx + beta0[:, None])
        W = ((1.0 - (qpos - d[:, None]).abs()).clamp_min(0.0)
             * (midx < grp.Lq))
        Tp = F.pad(T, (0, Wt)).contiguous()   # the last window's headroom
        out = anterp_taps(Tp, qi0.contiguous(), W.contiguous())
        return out.transpose(0, 1)                             # [B, V, Nt]

    # -- the measured ratios on the fine grid -----------------------------

    def resample_to_fine(self, R: torch.Tensor, grp: _Group) -> torch.Tensor:
        """Resample per-view t-grid signals R [B, nv, Nt] onto the group's
        fine grid with two clipped-lerp taps (sart_fast.py:394-443), one
        :func:`anterp_taps` call. Returns [Vpad, B, L]."""
        B = R.shape[0]
        if grp.V == 0:
            return R.new_zeros((grp.Vpad, B, grp.L))
        rv = R[:, torch.as_tensor(grp.local_ids, device=R.device)]
        rv = rv.transpose(0, 1).float()                        # [V, B, Nt]
        rv = F.pad(rv, (0, 1, 0, 0, 0, grp.Vpad - grp.V))     # [Vpad,B,Nt+1]
        tb = grp.tables(R.device)
        out = anterp_taps(rv.contiguous(), tb["rqi"], tb["rw"],
                          qi0_bounds=grp.bounds("rqi"))        # [Vpad,B,Lq]
        return F.pad(out, (0, grp.L - grp.Lq))


_SPLANS = {}


def _splan_for(g: FBPGeometry, nsubsets: int, fold: bool = False,
               sample_rate: int = 1) -> _SartFastPlan:
    k = (g.N, g.M, g.grid_n, g.grid_l, g.D, g.da, nsubsets, fold,
         sample_rate)
    if k not in _SPLANS:
        ids = np.arange(g.M // 2 if fold else g.M)
        if sample_rate > 1:
            ids = ids[::sample_rate]
        _SPLANS[k] = _SartFastPlan(g, nsubsets, view_ids=ids)
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
        nrm = []
        for s in range(S):
            bpn = bp_shift_accumulate_batched(
                vsub[s][:, None, :].contiguous(), s0[s], s1[s], frac[s],
                n)[0]
            nrm.append(torch.where(bpn > _EPS, 1.0 / bpn.clamp_min(_EPS),
                                   zero))
        s0_host = sp.subset_take(key, grp.tables("cpu")["s0"])
        per_drive[key] = dict(valid=valid,
                              inv2=sp.subset_take(key, inv2_rows).contiguous(),
                              nrmi=torch.stack(nrm).contiguous(),
                              s0=s0, frac=frac,
                              s0_bounds=(int(s0_host.min()),
                                         int(s0_host.max())))
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
                        nstart: int, ntv: int) -> torch.Tensor:
    """OS-SART of a batch of parallel sinograms par [B, nv, Nt] →
    [B, n, n] (fbp frame), one :func:`os_sart_sweep` call per drive axis
    per sweep (sart_fast.py:599-671). The relaxation and σ are host f32
    numbers, updated as the JAX scan updates them."""
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
            kw = dict(s0_bounds=d["s0_bounds"])
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
                      sample_rate: int = 1) -> torch.Tensor:
    """[B, na, nr] fan sinograms → [B, n, n] images in fbp_convert_fast
    orientation (sart_fast.py:741-772): the reference's recons_torch
    semantics (nstart sweeps, ntv TV steps per sweep, every sample_rate-th
    view) on the rebinned-parallel geometry, folded to a half turn when
    the view count is even, the fused sweep on the Kf=1 fine grid, the
    whole batch at once."""
    sample_rate = int(sample_rate)
    fold = g.M % 2 == 0
    sp = _splan_for(g, nsubsets, fold=fold, sample_rate=sample_rate)
    norms = _norms_for(sp, pj.device)
    par = _rebin(pj.float().flip(-1), sp.p)  # detector flip (fbp convention)
    if fold:
        M = g.M
        par = 0.5 * (par[:, :M // 2] + par[:, M // 2:].flip(-1))
    if sample_rate > 1:
        par = par[:, ::sample_rate]
    img = _sart_iterate_fused(sp, par, norms, int(nstart), int(ntv))
    return img.flip(-1)                      # x flip (fbp convention)

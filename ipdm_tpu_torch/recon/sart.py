"""OS-SART + NSL0-TV iterative reconstruction with the exact footprint
projector (port of ipdm_tpu/recon/sart.py).

The reference's DoReconstruction loop (TASART2DNSL0.cu:721-956) as the
JAX package restructures it: ordered-subset SART, the views grouped into
``nsubsets`` interleaved subsets (subset k = views k, k + nsubsets, ...),
every view of a subset computing its correction against the same volume
and one volume update per subset; relaxation λ = 0.24·0.95^sweep
(TASART2DNSL0.cu:730,924). After each sweep, ``ntv`` NSL0-TV steps
(Grad_NSL0TV, :483-539) with the nonnegative rule (:543-558), the step
α·‖Δx_SART‖ and the α / σ annealing (:830,892-925). As in the native
code, the returned volume is the post-SART (pre-TV) state of the last
sweep (x_res, TASART2DNSL0.cu:890,930).

The projector is ``recon/projector.py``'s, in plain PyTorch; a batch of
sinograms shares each subset's footprints, and each subset's two norms
(which do not depend on x) are computed in the first sweep and kept. The
fast OS-SART (recon/sart_fast.py) uses :func:`nsl0_tv_grad` too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ipdm_tpu_torch.recon.geometry import FanBeamGeometry
from ipdm_tpu_torch.recon.projector import (bp_norm_one_angle, bp_one_angle,
                                            footprint_for_angle,
                                            fp_norm_one_angle, fp_one_angle,
                                            pixel_centers)

# views per footprint block inside a subset (a full-width subset has 50)
SUBSET_BLOCK = 25


def nsl0_tv_grad(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Smoothed-L0 TV gradient with sech² weights (Grad_NSL0TV,
    TASART2DNSL0.cu:483-539) of a batch of images x [B, ny, nx]; edges
    replicate (the reference's texture clamp)."""
    mins = 1e-4
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    c = xp[:, 1:-1, 1:-1]
    right = xp[:, 1:-1, 2:]      # (x+1, y)
    down = xp[:, 2:, 1:-1]       # (x, y+1)
    left = xp[:, 1:-1, :-2]
    up = xp[:, :-2, 1:-1]
    up_right = xp[:, :-2, 2:]    # (x+1, y-1)
    left_down = xp[:, 2:, :-2]   # (x-1, y+1)

    def W(D):
        e = torch.exp(D / (2 * sigma)) + torch.exp(-D / (2 * sigma))
        return (2.0 / sigma) / (e * e)

    D_xy = torch.sqrt(mins * mins + (c - right) ** 2 + (c - down) ** 2)
    Dx_minus = torch.sqrt(mins * mins + (left - c) ** 2
                          + (left - left_down) ** 2)
    Dy_minus = torch.sqrt(mins * mins + (up - c) ** 2 + (up - up_right) ** 2)

    temp = W(D_xy) * ((c - right) + (c - down)) / D_xy
    temp = temp - W(Dx_minus) * (left - c) / Dx_minus
    temp = temp - W(Dy_minus) * (up - c) / Dy_minus
    return torch.where(temp < mins * mins, torch.zeros_like(temp), temp)


def _subset_update(x_flat: torch.Tensor, proj_rows: torch.Tensor,
                   betas_sub: torch.Tensor, lam: float,
                   geom: FanBeamGeometry, lut: torch.Tensor,
                   xy: torch.Tensor, norms: Optional[list] = None,
                   block: int = SUBSET_BLOCK) -> torch.Tensor:
    """One OS-SART volume update of x_flat [B, P] from a subset of views
    (proj_rows [B, V, nr], betas_sub [V] degrees).

    Per view: footprint → FP(x), FP(1) → correction (1/dr)·(m − p)/n
    (correction_kernel, TASART2DNSL0.cu:443-460) → BP; then
    x ← max(x + λ·Σbp/Σnorm, 0) (update_kernel, :462-479). ``norms`` is a
    list that holds the subset's FP(1) per block and Σ BP norm once a
    first call has filled it."""
    cached = bool(norms)
    bp = torch.zeros_like(x_flat)
    norm = None if cached else torch.zeros_like(x_flat[0])
    for j, v0 in enumerate(range(0, betas_sub.shape[0], block)):
        foot = footprint_for_angle(geom, lut, xy, betas_sub[v0:v0 + block])
        p = fp_one_angle(x_flat, foot, geom)              # [B, v, nr]
        if cached:
            n = norms[j]
        else:
            n = fp_norm_one_angle(foot, geom)             # [v, nr]
            norm += bp_norm_one_angle(foot, geom).sum(0)
            if norms is not None:
                norms.append(n)
        m = proj_rows[:, v0:v0 + block]
        corr = torch.where(n > 0.0, (1.0 / geom.dr) * (m - p) / n,
                           torch.zeros((), dtype=p.dtype, device=p.device))
        bp += bp_one_angle(corr, foot, geom).sum(1)
    if cached:
        norm = norms[-1]
    elif norms is not None:
        norms.append(norm)
    upd = torch.where(norm > 0.0, lam * bp / norm,
                      torch.zeros((), dtype=bp.dtype, device=bp.device))
    return (x_flat + upd).clamp_min(0.0)


def sart_reconstruct(proj: torch.Tensor, geom: FanBeamGeometry,
                     lut: torch.Tensor, betas: torch.Tensor,
                     nstart: int = 10, ntv: int = 0, nsubsets: int = 40,
                     sample_rate: int = 1,
                     x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reconstruct [na, nr] (or a batch [B, na, nr]) sinograms → [ny, nx]
    (or [B, ny, nx]) volumes: recons_torch (TASART2DNSL0_PyAPI.cpp:33-57)
    per item, without the binding's transpose (``recon/convertor.py``
    applies it). ``sample_rate`` keeps every k-th view (params.na =
    2000/sample_rate in the binding); ``nsubsets`` must divide what is
    left."""
    single = proj.dim() == 2
    if single:
        proj = proj[None]
    dev = proj.device
    na = geom.na // sample_rate
    if na % nsubsets:
        raise ValueError(f"nsubsets {nsubsets} must divide the number of "
                         f"views {na}")
    lut = torch.as_tensor(lut, dtype=torch.float32, device=dev)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    betas_used = betas[::sample_rate][:na]
    proj_used = proj[:, ::sample_rate][:, :na]
    sub_size = na // nsubsets
    # interleaved subsets: subset k = views [k, k+nsubsets, k+2·nsubsets, ...]
    order = torch.as_tensor(np.arange(na).reshape(sub_size, nsubsets).T,
                            device=dev)
    xy = torch.as_tensor(pixel_centers(geom), device=dev).reshape(-1, 2)
    B = proj.shape[0]
    P = geom.nx * geom.ny
    x = (torch.zeros((B, P), dtype=torch.float32, device=dev) if x0 is None
         else x0.reshape(B, P).to(torch.float32))
    # the sweep scalars as the JAX package carries them, in f32
    lam = np.float32(0.24)
    sigma = np.float32(0.8)
    alpha = torch.full((B,), 0.1, dtype=torch.float32, device=dev)
    norms = [[] for _ in range(nsubsets)]
    x_res = x
    for _ in range(nstart):
        x_back = x
        for k in range(nsubsets):
            idx = order[k]
            x = _subset_update(x, proj_used[:, idx], betas_used[idx],
                               float(lam), geom, lut, xy, norms[k])
        dp = torch.linalg.vector_norm(x - x_back, dim=1)
        x_res = x  # post-SART snapshot: the native output (cu:890,930)
        sigma = max(np.float32(sigma * np.float32(0.90)), np.float32(0.1))
        dtvg = alpha * dp
        if ntv > 0:
            x_pre_tv = x
            for _ in range(ntv):
                g = nsl0_tv_grad(x.reshape(B, geom.ny, geom.nx),
                                 float(sigma)).reshape(B, P)
                # nonnegative kernel (cu:543-558): x clamped; the gradient
                # set to 1e-8 where the pre-clamp x was negative and the
                # gradient positive
                g = torch.where((x < 0) & (g > 0),
                                torch.full((), 1e-8, device=dev), g)
                x = x.clamp_min(0.0)
                normg = torch.linalg.vector_norm(g, dim=1)
                x = x - (dtvg / normg)[:, None] * g
            dg = torch.linalg.vector_norm(x - x_pre_tv, dim=1)
            alpha = torch.where(dg > 0.995 * dp, alpha * 0.96, alpha)
        lam = np.float32(lam * np.float32(0.95))
    out = x_res.reshape(B, geom.ny, geom.nx)
    return out[0] if single else out

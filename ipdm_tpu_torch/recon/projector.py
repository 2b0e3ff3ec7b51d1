"""Matched fan-beam footprint projector pair, forward and back, in plain
PyTorch (port of ipdm_tpu/recon/projector.py).

The reference's trapezoid-footprint projectors (Recon/TASART2DNSL0-Cpp/
TASART2DNSL0.cu: update_lines_kernel :270, fetchAreaLut :253,
lut_init_foot_kernel :304, lut_fp_kernel :343, apply_geodiv_kernel :385,
lut_bp_kernel :397): per view, each pixel gets 5 detector-bin weights,
the differences of cumulative pixel / half-plane overlap areas read from
the area LUT. The JAX package computes this outside any Pallas kernel, as
elementwise XLA, and so does this module, as elementwise PyTorch on the
tensors' device.

The functions named "one angle" take one view or a block of views: a
:class:`Footprint` is [P] for one view and [V, P] for a block, and an
image is [P] or a batch [B, P]. The FP is a masked scatter-add
(``index_add_``), the BP the gather with clamp addressing, so the pair is
adjoint up to the FP's bin mask. :func:`forward_project_batch` computes
each block's footprint once for every image of the batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ipdm_tpu_torch.recon.geometry import FanBeamGeometry

# views per footprint block in forward_project (projector.py:182)
VIEW_BLOCK = 20


class Footprint(NamedTuple):
    """Per-pixel footprint of one view ([P]) or of a block of views
    ([V, P]), flattened over ny·nx pixels."""
    div: torch.Tensor    # [..., P] pixel-source distance
    s_bin: torch.Tensor  # [..., P] int64 first detector bin of the footprint
    areas: torch.Tensor  # [..., P, nfoot] overlap areas per bin


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (through f64): PyTorch's
    vectorised CPU sqrt can land one ulp off, and the pixel-source
    distance is held bit-equal to the JAX package's."""
    return torch.sqrt(t.double()).to(t.dtype)


def pixel_centers(geom: FanBeamGeometry) -> np.ndarray:
    """Pixel centers [ny, nx, 2] with the native indexing (iy major, ix
    minor; x from ix, y from iy), TASART2DNSL0.cu:316-317."""
    ix = np.arange(geom.nx, dtype=np.float64)
    iy = np.arange(geom.ny, dtype=np.float64)
    x = (ix + 0.5) * geom.dx - geom.xx + geom.offset_x
    y = (iy + 0.5) * geom.dy - geom.yy + geom.offset_y
    xy = np.stack(np.meshgrid(x, y, indexing="xy"), axis=-1)
    return xy.astype(np.float32)


def fold_angle_deg(ang: torch.Tensor) -> torch.Tensor:
    """Fold a direction angle in degrees ∈ [0,360) into [0°,45°] by octant
    (TASART2DNSL0.cu:291-298)."""
    a = torch.remainder(ang, 90.0)
    return torch.minimum(a, 90.0 - a)


def line_params(geom: FanBeamGeometry, beta: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detector-edge ray lines for view angle(s) beta (radians, [] or [V]).

    Returns (fold_ang_deg [..., nlines], abc [..., nlines, 3]) where
    abc·(x, y, 1) is the signed, unit-normalised pixel-line distance
    (update_lines_kernel, TASART2DNSL0.cu:270-301)."""
    nlines = geom.nr + 1
    beta = beta[..., None]
    src0 = -geom.dso * torch.sin(beta)
    src1 = geom.dso * torch.cos(beta)
    s0 = -geom.rr + geom.offset_r * geom.dr
    gamma = s0 + torch.arange(nlines, dtype=torch.float32,
                              device=beta.device) * geom.dr
    p1x = src0 + geom.dsd * torch.sin(beta + gamma)
    p1y = src1 - geom.dsd * torch.cos(beta + gamma)
    ang = torch.atan2(p1y - src1, p1x - src0) * (180.0 / math.pi)
    ang = torch.where(ang < 0, ang + 360.0, ang)
    A = p1y - src1
    B = src0 - p1x
    C = p1x * src1 - src0 * p1y
    Z = _sqrt(A * A + B * B)
    abc = torch.stack([A / Z, B / Z, C / Z], dim=-1)
    return fold_angle_deg(ang), abc


def fetch_area_lut(lut: torch.Tensor, geom: FanBeamGeometry,
                   fold_ang: torch.Tensor, pos: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear LUT sample with clamp addressing and the sign trick
    (fetchAreaLut, TASART2DNSL0.cu:253-268): fold_ang in degrees, pos the
    signed distance; a negative distance reads vox_base − area. Any
    shape."""
    ny_l, nx_l = lut.shape  # (ta_dimy, ta_dimx)
    u = (pos.abs() / geom.ta_dx).clamp(0.0, nx_l - 1.0)
    v = (fold_ang / geom.ta_dy).clamp(0.0, ny_l - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = (u0 + 1).clamp_max(nx_l - 1)
    v1 = (v0 + 1).clamp_max(ny_l - 1)
    fu = u - u0
    fv = v - v0
    flat = lut.reshape(-1)
    val = ((1 - fu) * (1 - fv) * flat[v0 * nx_l + u0]
           + fu * (1 - fv) * flat[v0 * nx_l + u1]
           + (1 - fu) * fv * flat[v1 * nx_l + u0]
           + fu * fv * flat[v1 * nx_l + u1])
    return torch.where(pos < 0.0, geom.vox_base - val, val)


def footprint_for_angle(geom: FanBeamGeometry, lut: torch.Tensor,
                        xy: torch.Tensor, beta_deg: torch.Tensor
                        ) -> Footprint:
    """div, s_bin and the nfoot footprint areas of every pixel at one view
    (beta_deg []) or a block of views ([V]) (lut_init_foot_kernel,
    TASART2DNSL0.cu:304-341). xy: [P, 2] f32 on the LUT's device."""
    beta = (beta_deg - geom.angle_start) * (math.pi / 180.0)
    fold_ang, abc = line_params(geom, beta)
    cs = torch.cos(beta)[..., None]
    sn = torch.sin(beta)[..., None]
    x, y = xy[:, 0], xy[:, 1]
    # src = R·(0, dso), uv_s = R·(1, 0), uv_t = R·(0, −1)
    dx_src = x - (-geom.dso * sn)
    dy_src = y - geom.dso * cs
    div = _sqrt(dx_src * dx_src + dy_src * dy_src)
    s_dot = x * cs + y * sn
    t_dot = x * sn + y * -cs
    gamma = torch.atan(s_dot / (t_dot + geom.dso))
    s_bin = (torch.floor(gamma / geom.dr + 0.5 * (geom.nr - 1)
                         - geom.offset_r).long() - geom.nfoot // 2)

    # nfoot + 1 cumulative areas at lines s_bin .. s_bin + nfoot, clamped
    # to the valid lines; the lines' tables gathered per view
    nlines = geom.nr + 1
    offs = torch.arange(geom.nfoot + 1, device=xy.device)
    idx = (s_bin[..., None] + offs).clamp(0, nlines - 1)   # [..., P, 6]
    lead = idx.shape[:-2]
    flat = idx.reshape(lead + (-1,))

    def take(tab):                                         # [..., nlines]
        return tab.gather(-1, flat).reshape(idx.shape)

    a = take(fold_ang)
    pos = (take(abc[..., 0]) * x[:, None] + take(abc[..., 1]) * y[:, None]
           + take(abc[..., 2]))
    A = fetch_area_lut(lut, geom, a, pos)
    areas = (A[..., :-1] - A[..., 1:]).abs()
    return Footprint(div=div, s_bin=s_bin, areas=areas)


def _views(foot: Footprint) -> Footprint:
    """The footprint as a block of views, [V, P]."""
    P = foot.div.shape[-1]
    return Footprint(foot.div.reshape(-1, P), foot.s_bin.reshape(-1, P),
                     foot.areas.reshape(-1, P, foot.areas.shape[-1]))


def fp_one_angle(x_flat: torch.Tensor, foot: Footprint,
                 geom: FanBeamGeometry) -> torch.Tensor:
    """Forward-project: proj[is] = (1/dr)·Σ_p x_p/div_p·area_{p,f}
    (lut_fp_kernel + apply_geodiv_kernel, TASART2DNSL0.cu:343-393), a
    scatter-add with the bins outside the detector masked. x_flat [P] or
    [B, P], foot [P] or [V, P]; returns [nr], [B, nr], [V, nr] or
    [B, V, nr]."""
    fv = _views(foot)
    V, P = fv.div.shape
    xb = x_flat.reshape(-1, P)
    vals = (xb[:, None] / fv.div)[..., None] * fv.areas    # [B, V, P, nf]
    offs = torch.arange(geom.nfoot, device=x_flat.device)
    idx = fv.s_bin[..., None] + offs                       # [V, P, nf]
    valid = (idx >= 0) & (idx < geom.nr)
    vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype,
                                                device=vals.device))
    idx = idx.clamp(0, geom.nr - 1) + geom.nr * torch.arange(
        V, device=idx.device)[:, None, None]
    proj = torch.zeros((xb.shape[0], V * geom.nr), dtype=x_flat.dtype,
                       device=x_flat.device)
    proj.index_add_(1, idx.reshape(-1), vals.reshape(xb.shape[0], -1))
    proj = proj * (1.0 / geom.dr)
    return proj.reshape(x_flat.shape[:-1] + foot.div.shape[:-1]
                        + (geom.nr,))


def fp_norm_one_angle(foot: Footprint, geom: FanBeamGeometry
                      ) -> torch.Tensor:
    """FP of the all-ones image (the SART row-sum normaliser), [nr] or
    [V, nr]."""
    ones = torch.ones(foot.div.shape[-1], dtype=foot.div.dtype,
                      device=foot.div.device)
    return fp_one_angle(ones, foot, geom)


def bp_one_angle(corr: torch.Tensor, foot: Footprint,
                 geom: FanBeamGeometry) -> torch.Tensor:
    """Back-project each view's correction onto the pixel grid:
    img[p] = Σ_f corr[clamp(s_bin+f)]·area/div (lut_bp_kernel,
    TASART2DNSL0.cu:397-441). Clamp addressing and no bound mask, as the
    CUDA texture reads it: a footprint bin past the detector's edge reads
    the edge bin. corr [nr] / [B, nr] for one view, [V, nr] / [B, V, nr]
    for a block; returns [P], [B, P], [V, P] or [B, V, P] (one image per
    view: the caller sums them)."""
    fv = _views(foot)
    V, P = fv.div.shape
    nf = fv.areas.shape[-1]
    lead = corr.shape[:-1 - (foot.div.dim() - 1)]
    cb = corr.reshape(-1, V, geom.nr)
    offs = torch.arange(geom.nfoot, device=corr.device)
    idx = (fv.s_bin[..., None] + offs).clamp(0, geom.nr - 1)
    g = cb.gather(2, idx.reshape(1, V, P * nf).expand(cb.shape[0], -1, -1))
    img = (g.reshape(-1, V, P, nf) * fv.areas).sum(-1) / fv.div
    return img.reshape(lead + foot.div.shape)


def bp_norm_one_angle(foot: Footprint, geom: FanBeamGeometry
                      ) -> torch.Tensor:
    """BP of the geodiv row (the val > 0 branch of lut_bp_kernel):
    norm[p] = (1/dr)·Σ_f area/div, [P] or [V, P]."""
    return foot.areas.sum(-1) / foot.div * (1.0 / geom.dr)


def forward_project_batch(x: torch.Tensor, geom: FanBeamGeometry,
                          lut: torch.Tensor, betas: torch.Tensor,
                          block: int = VIEW_BLOCK) -> torch.Tensor:
    """Sinograms of images x [B, ny, nx] → [B, na, nr] (the native
    DoProjection, TASART2DNSL0.cu:1335-1438; proj_torch,
    TASART2DNSL0_PyAPI.cpp:63-80), ``block`` views at a time, each
    block's footprint computed once for the whole batch."""
    dev = x.device
    xy = torch.as_tensor(pixel_centers(geom), device=dev).reshape(-1, 2)
    lut = torch.as_tensor(lut, dtype=torch.float32, device=dev)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    x_flat = x.reshape(x.shape[0], -1)
    out = []
    for v0 in range(0, geom.na, block):
        foot = footprint_for_angle(geom, lut, xy, betas[v0:v0 + block])
        out.append(fp_one_angle(x_flat, foot, geom))
    return torch.cat(out, dim=1)


def forward_project(x: torch.Tensor, geom: FanBeamGeometry,
                    lut: torch.Tensor, betas: torch.Tensor,
                    block: int = VIEW_BLOCK) -> torch.Tensor:
    """Sinogram of one image x [ny, nx] → [na, nr]."""
    return forward_project_batch(x[None], geom, lut, betas, block)[0]

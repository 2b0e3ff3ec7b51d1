"""Equiangular fan-beam filtered backprojection (port of
ipdm_tpu/recon/fbp.py).

Plain numpy constants of the reference FBP (Recon/FBP_kernel.py:32-60):
source-axis 59.5 cm, axis-detector 49.06 cm, 912 detectors at
Δγ = 0.0010125 rad with a +3.75-bin offset, 2000 views over 360° in 0.18°
steps, a 512² grid of half-size L = 21 cm. The fast converter
(recon/fbp_fast.py) plans from these.

:func:`fbp_convert` is the reference's direct fan-beam FBP (the
``exact_fbp`` convertor, FBP_kernel.py:86-122): cosine weighting, the R-L
ramp kernel applied as an rFFT convolution (equal to the 'full'
convolution's slice [N−1 : 2N−1]), then a per-view gather with linear
detector interpolation and 1/L² distance weighting, over blocks of views,
in plain PyTorch on the sinogram's device. The detector axis is flipped on
input and the image flipped back on output.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


class FBPGeometry:
    """Precomputed constants of the reference FBP (FBP_kernel.py:32-60)."""

    def __init__(self, n_det: int = 912, n_views: int = 2000,
                 grid_n: int = 512, grid_l: float = 21.0, os_: float = 59.5,
                 od: float = 49.06, da: float = 0.0010125,
                 det_offset: float = 3.75, view_step_deg: float = 0.18):
        self.N = n_det
        self.M = n_views
        self.grid_n = grid_n
        self.grid_l = grid_l
        self.D = os_
        self.da = da
        self.theta = (np.arange(n_views) * view_step_deg / 180.0 * np.pi
                      ).astype(np.float64)
        self.nda = (np.arange(-n_det / 2 + 0.5 + det_offset,
                              n_det / 2 - 0.5 + det_offset + 1)
                    * da).astype(np.float32)
        # R-L ramp kernel, length 2N−1 (FBP_kernel.py:52-56)
        h = np.zeros(2 * n_det - 1, dtype=np.float64)
        ngamma = np.arange(-n_det + 1, n_det, 2) * da
        h[0::2] = -0.5 / np.pi ** 2 / (np.sin(ngamma) ** 2)
        h[n_det - 1] = 1 / 8 / da ** 2
        self.h_RL = (h * da).astype(np.float32)
        # per-pixel polar coordinates (FBP_kernel.py:69-84)
        self.r, self.phi = self._getrphi()

    def _getrphi(self) -> Tuple[np.ndarray, np.ndarray]:
        n, L = self.grid_n, self.grid_l
        cx = cy = n / 2
        i, j = np.meshgrid(np.arange(1, n + 1), np.arange(1, n + 1),
                           indexing="ij")
        y = (n + 1 - i - cx - 0.5) * 2 * L / n
        x = (j - cy - 0.5) * 2 * L / n
        r = np.sqrt(x ** 2 + y ** 2)
        phi = np.arctan(y / x)
        phi[x < 0] += np.pi
        phi[phi < 0] += 2 * np.pi
        return r.astype(np.float32), phi.astype(np.float32)


SIEMENS_FBP = FBPGeometry()


def ramp_filter(pj: torch.Tensor, h_RL, n_det: int) -> torch.Tensor:
    """Filter [.., M, N] weighted projections with the ramp kernel by rFFT
    (≡ np.convolve(kernel, row)[N−1 : 2N−1], FBP_kernel.py:125-131)."""
    L = int(2 ** math.ceil(math.log2(3 * n_det - 2)))
    h = torch.as_tensor(h_RL, dtype=pj.dtype, device=pj.device)
    K = torch.fft.rfft(h, n=L)
    P = torch.fft.rfft(pj, n=L, dim=-1)
    full = torch.fft.irfft(P * K, n=L, dim=-1)
    return full[..., n_det - 1: 2 * n_det - 1]


def fbp_convert(pj: torch.Tensor, g: FBPGeometry = SIEMENS_FBP,
                view_block: int = 50, flip: bool = True,
                theta=None) -> torch.Tensor:
    """Direct fan-beam FBP of [B, M, N] sinograms → [B, n, n] images
    (reference convert, FBP_kernel.py:86-122), ``view_block`` views at a
    time. ``theta`` (radians, default ``g.theta``) are the angles of
    pj's views: a wedge of the scan gives that wedge's share of the
    image (``parallel/mesh.py``'s view-sharded FBP)."""
    dev = pj.device
    if flip:
        pj = pj.flip(2)
    # cosine weighting and the Δθ scale (FBP_kernel.py:104-105)
    w = torch.as_tensor((g.D * np.cos(g.nda)).astype(np.float32), device=dev)
    dtheta = float(np.float32(g.theta[1] - g.theta[0]))
    pj = pj * w * dtheta
    pj = ramp_filter(pj, g.h_RL, g.N)

    r = torch.as_tensor(g.r, device=dev).reshape(-1)
    phi = torch.as_tensor(g.phi, device=dev).reshape(-1)
    nda0 = float(np.float32(g.nda[0]))
    da = float(np.float32(g.da))
    D = float(np.float32(g.D))
    half_pi = float(np.float32(np.pi / 2))
    theta = torch.as_tensor(g.theta if theta is None else theta,
                            dtype=torch.float32, device=dev)
    B = pj.shape[0]
    n = g.grid_n
    img = torch.zeros((B, n * n), dtype=pj.dtype, device=dev)
    for v0 in range(0, len(theta), view_block):
        beta = theta[v0:v0 + view_block] - half_pi
        th = (half_pi + beta)[:, None] + phi                  # [vb, n²]
        denom = D + r * torch.cos(th)
        alpha = torch.atan(r * torch.sin(th) / denom)
        pos = (alpha - nda0) / da + 0.5
        curdet = torch.floor(pos)
        lam = pos - curdet
        Lw = r * torch.sin(th) / torch.sin(alpha)
        ci = curdet.long()
        valid = (ci > 0) & (ci < g.N)
        c0 = (ci - 1).clamp(0, g.N - 1)
        c1 = ci.clamp(0, g.N - 1)
        blk = pj[:, v0:v0 + view_block]                       # [B, vb, N]
        p0 = blk.gather(2, c0[None].expand(B, -1, -1))
        p1 = blk.gather(2, c1[None].expand(B, -1, -1))
        v = ((1 - lam) * p0 + lam * p1) / (Lw * Lw)
        img += torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                 device=dev)).sum(1)
    img = img.reshape(B, n, n)
    if flip:
        img = img.flip(2)
    return img

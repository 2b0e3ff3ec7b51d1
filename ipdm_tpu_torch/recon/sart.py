"""The smoothed-L0 TV gradient of the SART's TV steps (port of
ipdm_tpu/recon/sart.py:40-64, ``nsl0_tv_grad``). The exact fan-beam
footprint SART of that module is ported with a later slice; the fast
OS-SART (recon/sart_fast.py) uses this gradient when ``ntv > 0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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

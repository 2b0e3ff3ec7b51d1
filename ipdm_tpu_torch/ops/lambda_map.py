"""Per-pixel guidance-decay λ map (port of ipdm_tpu/ops/lambda_map.py; the
reference computes it with the numba CUDA kernel
``condition_lambda_ratio_cuda``, Model/model.py:328-351).

Math (per pixel, with per-pixel exponent λp = delt[b, c, i, j]):
    a(x)  = cos(((x/ts)+s)/(1+s)·π/2)²
    I     = 1 − (a(i+1)^λp / a(i)^λp)        # the a(0)^λp factors cancel
clipped to [0.05, 0.99] (model.py:558) and nearest-upsampled from the
pooled grid to full resolution (model.py:559-560). Tensors are NCHW.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def condition_lambda_map(delt: torch.Tensor, i: int, timesteps: int,
                         s: float = 0.008) -> torch.Tensor:
    """λ map at reverse step i from the pooled per-pixel exponent delt
    (any shape). The scalar ratio a(i+1)/a(i) is computed in f32, as the
    JAX map computes it on the device."""
    half_pi_over = np.float32(math.pi * 0.5 / (1 + s))
    ts, s32 = np.float32(timesteps), np.float32(s)

    def a(x):
        return np.cos((np.float32(x) / ts + s32) * half_pi_over) ** 2

    ratio = float(a(i + 1) / a(i))
    return (1.0 - torch.pow(ratio, delt)).clamp(0.05, 0.99)


def nearest_upsample(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW x to spatial ``size`` with the
    floor-index convention of torch's F.interpolate(mode='nearest')
    (reference model.py:559-560). An exact multiple is a repeat."""
    H, W = x.shape[2], x.shape[3]
    if size[0] % H == 0 and size[1] % W == 0:
        x = x.repeat_interleave(size[0] // H, dim=2)
        return x.repeat_interleave(size[1] // W, dim=3)
    hi = torch.arange(size[0], device=x.device) * H // size[0]
    wi = torch.arange(size[1], device=x.device) * W // size[1]
    return x.index_select(2, hi).index_select(3, wi)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k×k average pool of NCHW x; a trailing remainder is
    dropped, as F.avg_pool2d drops it."""
    B, C, H, W = x.shape
    Hk, Wk = H // k, W // k
    x = x[:, :, :Hk * k, :Wk * k].reshape(B, C, Hk, k, Wk, k)
    return x.mean(dim=(3, 5))

"""3×3 high-pass sharpen applied to FBP output before image-domain
diffusion (port of ipdm_tpu/ops/sharpen.py; reference tensor_sharpen,
Utils/train_test_utils.py:868-878)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tensor_sharpen(img: torch.Tensor, N: int = 60) -> torch.Tensor:
    """img: NHWC. Depthwise kernel [[-2,-2,-2],[-2,N,-2],[-2,-2,-2]]/(N-16),
    zero padding 1. N == -1 is the identity."""
    if N == -1:
        return img
    k = torch.full((3, 3), -2.0, dtype=img.dtype, device=img.device)
    k[1, 1] = float(N)
    k = k / (N - 16.0)
    C = img.shape[-1]
    y = F.conv2d(img.permute(0, 3, 1, 2), k.expand(C, 1, 3, 3), padding=1,
                 groups=C)
    return y.permute(0, 2, 3, 1)

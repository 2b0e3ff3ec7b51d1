"""PSNR and SSIM, numerically compatible with the reference's metric calls
(skimage peak_signal_noise_ratio and structural_similarity with win_size=11,
uniform windows — Utils/train_test_utils.py:793-798).

Implemented on numpy (metrics run host-side in the reference too). Port of
ipdm_tpu/metrics/psnr_ssim.py.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(image_true: np.ndarray, image_test: np.ndarray,
         data_range: float = 1.0) -> float:
    err = np.mean((np.asarray(image_true, np.float64)
                   - np.asarray(image_test, np.float64)) ** 2)
    return float(10 * np.log10((data_range ** 2) / err))


def ssim(im1: np.ndarray, im2: np.ndarray, win_size: int = 11,
         data_range: float = 1.0) -> float:
    """Mean SSIM with uniform window, skimage-compatible: sample (unbiased)
    covariance normalisation and edge crop of (win_size-1)//2."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)

    f = lambda a: uniform_filter(a, size=win_size)
    ux = f(im1)
    uy = f(im2)
    uxx = f(im1 * im1)
    uyy = f(im2 * im2)
    uxy = f(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) \
        / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())

"""Pixel-domain Visual Information Fidelity (VIF-P, Sheikh & Bovik 2006).

Replaces the reference's piq.vif_p call (Utils/train_test_utils.py:28,804)
with a native implementation following the same conventions piq uses: inputs
scaled to [0,255] by data_range, 4 scales with Gaussian kernels of size
2^(5-s)+1 (σ = size/5), valid-mode convolutions, ×2 decimation between scales,
GSM noise variance σ_n² = 2, piq's EPS=1e-8 in the zero-variance guards, and
piq's final (num+EPS)/(den+EPS) score. Cross-validated against an
independent torch transliteration of the piq algorithm in
tests/piq_oracle.py (tests/test_metric_parity.py).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _valid_conv(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    full = convolve(img, k, mode="constant", cval=0.0)
    ph, pw = k.shape[0] // 2, k.shape[1] // 2
    return full[ph:img.shape[0] - ph, pw:img.shape[1] - pw]


def vif_p(x: np.ndarray, y: np.ndarray, data_range: float = 1.0,
          sigma_n_sq: float = 2.0) -> float:
    """VIF of distorted y against reference x."""
    x = np.asarray(x, np.float64) / data_range * 255.0
    y = np.asarray(y, np.float64) / data_range * 255.0
    eps = 1e-8  # piq's EPS
    num = 0.0
    den = 0.0
    for scale in range(1, 5):
        size = 2 ** (4 - scale + 1) + 1
        kern = _gaussian_kernel(size, size / 5.0)
        if scale > 1:
            x = _valid_conv(x, kern)[::2, ::2]
            y = _valid_conv(y, kern)[::2, ::2]
        mu_x = _valid_conv(x, kern)
        mu_y = _valid_conv(y, kern)
        sigma_x_sq = _valid_conv(x * x, kern) - mu_x ** 2
        sigma_y_sq = _valid_conv(y * y, kern) - mu_y ** 2
        sigma_xy = _valid_conv(x * y, kern) - mu_x * mu_y
        sigma_x_sq = np.maximum(sigma_x_sq, 0.0)
        sigma_y_sq = np.maximum(sigma_y_sq, 0.0)

        g = sigma_xy / (sigma_x_sq + eps)
        sv_sq = sigma_y_sq - g * sigma_xy

        g[sigma_x_sq < eps] = 0.0
        sv_sq[sigma_x_sq < eps] = sigma_y_sq[sigma_x_sq < eps]
        sigma_x_sq[sigma_x_sq < eps] = 0.0
        sv_sq[sigma_y_sq < eps] = 0.0
        g[sigma_y_sq < eps] = 0.0
        sv_sq[g < 0] = sigma_y_sq[g < 0]
        g[g < 0] = 0.0
        sv_sq[sv_sq <= eps] = eps

        num += np.sum(np.log10(1.0 + g ** 2 * sigma_x_sq
                               / (sv_sq + sigma_n_sq)))
        den += np.sum(np.log10(1.0 + sigma_x_sq / sigma_n_sq))
    return float((num + eps) / (den + eps))

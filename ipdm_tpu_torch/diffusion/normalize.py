"""Yeo-Johnson Gaussianization (the reference's opt.normal path).

Native replacement for the sklearn PowerTransformer usage in the reference
(Model/model.py:762-807): fit λ by maximum likelihood over the flattened
image, transform, then standardize to zero mean / unit (sample) std — exactly
PowerTransformer(method='yeo-johnson', standardize=True) semantics — with the
closed-form inverse. The λ MLE uses scipy's Brent optimiser on the exact
Yeo-Johnson log-likelihood (what sklearn calls internally), so fitted λ values
match sklearn to optimizer precision (validated in tests when sklearn is
importable).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import stats


class YeoJohnsonTransformer:
    """Fitted Yeo-Johnson transform with standardization; numpy in/out."""

    def __init__(self, lmbda: float, mean: float, std: float):
        self.lmbda = float(lmbda)
        self.mean = float(mean)
        self.std = float(std)

    @classmethod
    def fit(cls, x: np.ndarray) -> "YeoJohnsonTransformer":
        flat = np.asarray(x, dtype=np.float64).reshape(-1)
        transformed, lmbda = stats.yeojohnson(flat)
        mean = transformed.mean()
        std = transformed.std(ddof=1)  # sklearn StandardScaler uses ddof=0;
        # PowerTransformer standardize uses ddof=0 — use population std
        std = transformed.std(ddof=0)
        return cls(lmbda, mean, std)

    def transform(self, x: np.ndarray) -> np.ndarray:
        shape = np.shape(x)
        y = stats.yeojohnson(np.asarray(x, np.float64).reshape(-1), self.lmbda)
        return ((y - self.mean) / self.std).reshape(shape).astype(np.float32)

    def inverse_transform(self, y: np.ndarray) -> np.ndarray:
        shape = np.shape(y)
        z = np.asarray(y, np.float64).reshape(-1) * self.std + self.mean
        lam = self.lmbda
        x = np.empty_like(z)
        pos = z >= 0
        # positive branch
        if abs(lam) < 1e-12:
            x[pos] = np.expm1(z[pos])
        else:
            x[pos] = np.power(np.maximum(z[pos] * lam + 1.0, 0.0),
                              1.0 / lam) - 1.0
        # negative branch
        if abs(lam - 2.0) < 1e-12:
            x[~pos] = -np.expm1(-z[~pos])
        else:
            x[~pos] = 1.0 - np.power(
                np.maximum(-(2.0 - lam) * z[~pos] + 1.0, 0.0),
                1.0 / (2.0 - lam))
        return x.reshape(shape).astype(np.float32)


def yeo_johnson_transform(x: np.ndarray
                          ) -> Tuple[np.ndarray, YeoJohnsonTransformer]:
    """Fit + transform, like reference yeo_johnson_transform
    (model.py:762-784). Host-side numpy (the fit is an MLE; it runs once per
    sample, off the device hot path)."""
    tr = YeoJohnsonTransformer.fit(x)
    return tr.transform(x), tr


def yeo_johnson_inverse_transform(y: np.ndarray,
                                  transformer: YeoJohnsonTransformer
                                  ) -> np.ndarray:
    """Inverse, like reference yeo_johnson_inverse_transform
    (model.py:786-807)."""
    return transformer.inverse_transform(y)

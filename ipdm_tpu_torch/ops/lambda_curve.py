"""Residual-magnitude → guidance-exponent curves (port of
ipdm_tpu/ops/lambda_curve.py).

The reference fits two piecewise polynomials per domain with np.polyfit on
hard-coded knots (Utils/train_test_utils.py:831-865). The fits run once in
numpy at construction; evaluation is a clamp, two f32 Horner polynomials
and a select, on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

# knot tables (train_test_utils.py:842-865)
_IMG_X1 = [1, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6, 1.7]
_IMG_Y1 = [20, 17.5, 15, 12, 8.5, 5, 2, 1]
_IMG_X2 = [1.7, 1.8, 2.0, 2.2, 2.35, 2.5, 3]
_IMG_Y2 = [1, 0.7, 0.5, 0.3, 0.2, 0.1, 0.05]

_PROJ_X1 = [1, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6, 1.7]
_PROJ_Y1 = [20, 17.5, 15, 12, 8.5, 7.5, 5, 4]
_PROJ_X2 = [1.7, 1.8, 2.0, 2.2, 2.35, 2.5, 3, 3.5]
_PROJ_Y2 = [4, 3, 2, 1, 0.5, 0.3, 0.1, 0.01]


def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation in f32, highest power first (as jnp.polyval)."""
    out = torch.zeros_like(x)
    for c in coeffs:
        out = out * x + c
    return out


class LambdaCurve:
    """Piecewise curve: f1 (deg-4) on [1, 1.7], f2 (deg-2) on (1.7, 2.75],
    clamped to f1(1) below 1 and f2(2.75) above 2.75
    (reference weight_lambda, train_test_utils.py:831-839)."""

    def __init__(self, x1, y1, x2, y2):
        self.p1 = np.polyfit(x1, y1, 4)
        self.p2 = np.polyfit(x2, y2, 2)
        # the coefficients as f32 numbers, as the JAX curve holds them
        self._p1 = [float(c) for c in self.p1.astype(np.float32)]
        self._p2 = [float(c) for c in self.p2.astype(np.float32)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.float().clamp(1.0, 2.75)
        return torch.where(xc <= 1.7, _polyval(self._p1, xc),
                           _polyval(self._p2, xc))


def curve_init() -> LambdaCurve:
    """Image-domain curve (train_test_utils.py:842-852)."""
    return LambdaCurve(_IMG_X1, _IMG_Y1, _IMG_X2, _IMG_Y2)


def proj_curve_init() -> LambdaCurve:
    """Projection-domain curve (train_test_utils.py:855-865)."""
    return LambdaCurve(_PROJ_X1, _PROJ_Y1, _PROJ_X2, _PROJ_Y2)

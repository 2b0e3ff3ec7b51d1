"""Equiangular fan-beam FBP geometry (port of ipdm_tpu/recon/fbp.py:32-73).

Plain numpy constants of the reference FBP (Recon/FBP_kernel.py:32-60):
source-axis 59.5 cm, axis-detector 49.06 cm, 912 detectors at
Δγ = 0.0010125 rad with a +3.75-bin offset, 2000 views over 360° in 0.18°
steps, a 512² grid of half-size L = 21 cm. The fast converter
(recon/fbp_fast.py) plans from these; the direct fan-beam ``fbp_convert``
is ported with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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

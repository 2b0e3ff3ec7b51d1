"""Shepp-Logan phantom generator for physics tests and benchmarks (port of
ipdm_tpu/recon/phantom.py).

The reference has no phantom module (its native smoke test reads a hardcoded
binary sinogram, TASART2DNSL0_cpu.cpp:50-151); a synthetic phantom lets every
projector/FBP/SART property be tested without the (unshipped) Mayo data.
"""

from __future__ import annotations

import numpy as np

# (intensity, a, b, x0, y0, angle_deg) — standard Shepp-Logan ellipses,
# modified (Toft) contrast variant for visibility.
_ELLIPSES = [
    (1.00, 0.69, 0.92, 0.0, 0.0, 0),
    (-0.80, 0.6624, 0.8740, 0.0, -0.0184, 0),
    (-0.20, 0.1100, 0.3100, 0.22, 0.0, -18),
    (-0.20, 0.1600, 0.4100, -0.22, 0.0, 18),
    (0.10, 0.2100, 0.2500, 0.0, 0.35, 0),
    (0.10, 0.0460, 0.0460, 0.0, 0.1, 0),
    (0.10, 0.0460, 0.0460, 0.0, -0.1, 0),
    (0.10, 0.0460, 0.0230, -0.08, -0.605, 0),
    (0.10, 0.0230, 0.0230, 0.0, -0.606, 0),
    (0.10, 0.0230, 0.0460, 0.06, -0.605, 0),
]


def shepp_logan(n: int = 512, scale: float = 1.0) -> np.ndarray:
    """n×n modified Shepp-Logan phantom in [0, ~scale]."""
    y, x = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                       indexing="ij")
    img = np.zeros((n, n), dtype=np.float64)
    for inten, a, b, x0, y0, ang in _ELLIPSES:
        th = np.deg2rad(ang)
        xr = (x - x0) * np.cos(th) + (y - y0) * np.sin(th)
        yr = -(x - x0) * np.sin(th) + (y - y0) * np.cos(th)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += inten
    return (img * scale).astype(np.float32)


def miu_phantom(n: int = 512) -> np.ndarray:
    """Phantom scaled to plausible attenuation coefficients (μ ≈ 0-0.36,
    water 0.183 — matching the dataset's μ maps)."""
    return shepp_logan(n, scale=0.36)


def random_ellipse_phantom(n: int, rng: "np.random.Generator",
                           n_ellipses: int = 8) -> np.ndarray:
    """Random anatomy-like phantom: a body ellipse plus n_ellipses random
    inclusions, scaled to attenuation coefficients (μ ≈ 0-0.36). Used to
    synthesise training corpora when no CT data ships with the repo."""
    y, x = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                       indexing="ij")
    img = np.zeros((n, n), np.float64)
    # body
    img[(x / 0.85) ** 2 + (y / 0.92) ** 2 <= 1.0] = 1.0
    for _ in range(n_ellipses):
        a, b = rng.uniform(0.05, 0.4, 2)
        x0, y0 = rng.uniform(-0.5, 0.5, 2)
        th = rng.uniform(0, np.pi)
        inten = rng.uniform(-0.4, 0.6)
        xr = (x - x0) * np.cos(th) + (y - y0) * np.sin(th)
        yr = -(x - x0) * np.sin(th) + (y - y0) * np.cos(th)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += inten
    img = np.clip(img, 0.0, 2.0)
    return (img * 0.183).astype(np.float32)

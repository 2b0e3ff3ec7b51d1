"""Equiangular fan-beam CT geometry and the trapezoid-footprint area LUT
(port of ipdm_tpu/recon/geometry.py:30-131).

Geometry conventions follow the native reconstructor:
  * source at R(β)·(0, dso), detector arc of nr equiangular bins of width dr
    (radians), detector offset offset_r bins;
  * pixel (ix, iy) center at ((ix+.5)·dx − nx·dx/2 + offset_x,
                              (iy+.5)·dy − ny·dy/2 + offset_y);
  * the LUT maps (|signed line-pixel distance|, folded line angle ∈ [0°,45°])
    → overlap area of the pixel with the half-plane beyond the line.

The fast convertors plan from the FBP parameterisation of the same scanner
(``recon/convertor.py::fbp_geom_from_fan``); the exact footprint projector
(``recon/projector.py``) reads the LUT, which is derived analytically here
(exact square / half-plane overlap areas, numpy), so no table file is
needed.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FanBeamGeometry:
    dso: float = 59.5            # source-isocenter distance (cm)
    dsd: float = 108.56          # source-detector distance (cm)
    nx: int = 512                # image grid
    ny: int = 512
    dx: float = 42.0 / 512.0     # pixel pitch (cm)
    dy: float = 42.0 / 512.0
    offset_x: float = 0.0
    offset_y: float = 0.0
    nr: int = 912                # detector bins
    dr: float = 0.0010125        # bin angular pitch (rad)
    offset_r: float = -3.75      # detector center offset (bins)
    angle_start: float = 0.0     # degrees
    na: int = 2000               # views
    ta_dimx: int = 1501          # LUT distance samples
    ta_dimy: int = 181           # LUT angle samples (0..45° by 0.25°)
    nfoot: int = 5               # footprint bins per pixel

    @property
    def ta_dx(self) -> float:
        """LUT distance step: half pixel diagonal / (ta_dimx-1)."""
        return self.dx * math.sqrt(2.0) * 0.5 / (self.ta_dimx - 1)

    @property
    def ta_dy(self) -> float:
        """LUT angle step in degrees: 45 / (ta_dimy-1)."""
        return 45.0 / (self.ta_dimy - 1)

    @property
    def vox_base(self) -> float:
        return abs(self.dx * self.dy)

    @property
    def xx(self) -> float:
        return self.nx * self.dx * 0.5

    @property
    def yy(self) -> float:
        return self.ny * self.dy * 0.5

    @property
    def rr(self) -> float:
        return self.nr * self.dr * 0.5

    def replace(self, **kw) -> "FanBeamGeometry":
        return dataclasses.replace(self, **kw)


SIEMENS = FanBeamGeometry()


def default_betas(geom: FanBeamGeometry = SIEMENS) -> np.ndarray:
    """View angles in degrees: uniform 360°/na steps (the reference's
    Simens_theta.txt is arange(2000)·0.18° in float32)."""
    return (np.arange(geom.na) * (360.0 / geom.na)).astype(np.float32)


def _halfplane_area(d: np.ndarray, phi: np.ndarray, h: float) -> np.ndarray:
    """Exact area of the square [-h,h]² beyond the line n·p = d, where
    n = (cos φ, sin φ), φ ∈ [0°,45°] in radians, d ≥ 0.

    The integrand clip(h − (d − cosφ·x)/sinφ, 0, 2h) is piecewise linear in
    x, integrated in closed form; φ = 0 is the axis-aligned limit."""
    t = np.cos(phi)
    s = np.sin(phi)
    with np.errstate(divide="ignore", invalid="ignore"):
        x0 = (d - h * s) / t  # u(x0) = 0
        x1 = (d + h * s) / t  # u(x1) = 2h
        c0 = np.clip(x0, -h, h)
        c1 = np.clip(x1, -h, h)

        def F(x):
            # antiderivative of u(x) = (h·s − d + t·x)/s
            return ((h * s - d) * x + 0.5 * t * x * x) / s

        area = 2 * h * (h - c1) + (F(c1) - F(c0))
    area_axis = 2 * h * (h - np.clip(d, -h, h))
    return np.where(s < 1e-12, area_axis, area)


def area_lut(geom: FanBeamGeometry = SIEMENS) -> np.ndarray:
    """Analytic (ta_dimy, ta_dimx) trapezoid-area LUT, float32.

    Entry [j, i]: overlap area of a dx×dy pixel with the half-plane at
    signed distance i·ta_dx from the pixel center, for a line whose folded
    direction angle is j·ta_dy degrees (the reference's Simens_alut.txt,
    1501×181 f32, to float32 rounding)."""
    if geom.dx != geom.dy:
        raise ValueError("the analytic LUT assumes square pixels "
                         f"(dx {geom.dx} != dy {geom.dy})")
    h = geom.dx * 0.5
    d = (np.arange(geom.ta_dimx, dtype=np.float64) * geom.ta_dx)[None, :]
    phi = np.deg2rad(np.arange(geom.ta_dimy, dtype=np.float64)
                     * geom.ta_dy)[:, None]
    area = _halfplane_area(d, phi, h)
    return np.clip(area, 0.0, geom.vox_base).astype(np.float32)


def load_area_lut(path: str, geom: FanBeamGeometry = SIEMENS) -> np.ndarray:
    """A binary f32 LUT file in the reference's format."""
    sa = np.fromfile(path, dtype=np.float32)
    return sa.reshape(geom.ta_dimy, geom.ta_dimx)

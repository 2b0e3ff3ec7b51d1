"""Equiangular fan-beam CT geometry (port of
ipdm_tpu/recon/geometry.py:30-78).

Geometry conventions follow the native reconstructor:
  * source at R(β)·(0, dso), detector arc of nr equiangular bins of width dr
    (radians), detector offset offset_r bins;
  * pixel (ix, iy) center at ((ix+.5)·dx − nx·dx/2 + offset_x,
                              (iy+.5)·dy − ny·dy/2 + offset_y).

The fast convertors plan from the FBP parameterisation of the same scanner
(``recon/convertor.py::fbp_geom_from_fan``). The trapezoid-footprint area
LUT and the view-angle table belong to the exact footprint SART and are
ported with it; ``ta_dimx`` / ``ta_dimy`` / ``nfoot`` are kept as fields so
a geometry override written for the JAX package loads unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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
    ta_dimx: int = 1501          # LUT distance samples (exact SART)
    ta_dimy: int = 181           # LUT angle samples (exact SART)
    nfoot: int = 5               # footprint bins per pixel (exact SART)

    def replace(self, **kw) -> "FanBeamGeometry":
        return dataclasses.replace(self, **kw)


SIEMENS = FanBeamGeometry()

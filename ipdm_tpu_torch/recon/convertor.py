"""Domain-convertor facade: sinogram → image (port of
ipdm_tpu/recon/convertor.py:60-124, the fast paths).

``Convertor(kind)(pj)`` maps [B, na, nr] sinograms to [B, n, n] images:
"FBP" through the fast rebinned FBP (recon/fbp_fast.py), "ART" through
the fast OS-SART (recon/sart_fast.py: ``nstart`` sweeps over ``nsubsets``
ordered subsets, every ``sample_rate``-th view), "TV" as ART with at least
one TV step per sweep. The scanner is a ``FanBeamGeometry`` (``geom=``,
seen through the FBP parameterisation by :func:`fbp_geom_from_fan`) or an
``FBPGeometry`` given directly (``fbp_geom=``). The reference-faithful
exact FBP and footprint SART (``exact_fbp`` / ``exact_art``), with their
area LUT and view-angle table, are ported with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry
from ipdm_tpu_torch.recon.fbp_fast import fbp_convert_fast
from ipdm_tpu_torch.recon.geometry import SIEMENS, FanBeamGeometry
from ipdm_tpu_torch.recon.sart_fast import sart_fast_convert


def fbp_geom_from_fan(geom: FanBeamGeometry) -> FBPGeometry:
    """The FBP geometry of a FanBeamGeometry (the same scanner through the
    FBP code's parameterisation; det_offset flips sign because the FBP
    path flips the detector axis)."""
    return FBPGeometry(n_det=geom.nr, n_views=geom.na, grid_n=geom.nx,
                       grid_l=geom.nx * geom.dx / 2.0, os_=geom.dso,
                       od=geom.dsd - geom.dso, da=geom.dr,
                       det_offset=-geom.offset_r,
                       view_step_deg=360.0 / geom.na)


class Convertor:
    """Callable convertor the denoisers use (reference init_convertor,
    Utils/train_test_utils.py:225-233)."""

    def __init__(self, kind: str, fbp_geom: Optional[FBPGeometry] = None, *,
                 geom: FanBeamGeometry = SIEMENS, nstart: int = 10,
                 ntv: int = 0, nsubsets: int = 40, sample_rate: int = 1):
        if kind not in ("FBP", "ART", "TV"):
            raise ValueError(f"convertor {kind!r}: 'FBP', 'ART' or 'TV'")
        self.kind = kind
        self.geom = geom
        if fbp_geom is None:
            fbp_geom = (SIEMENS_FBP if geom is SIEMENS
                        else fbp_geom_from_fan(geom))
        self.fbp_geom = fbp_geom
        # the subset count divides the view count (convertor.py:96-97)
        while nsubsets > 1 and self.fbp_geom.M % nsubsets:
            nsubsets -= 1
        self.nsubsets = nsubsets
        self.ntv = ntv if kind != "TV" else max(ntv, 1)
        self.nstart = nstart
        self.sample_rate = sample_rate

    def convert(self, pj: torch.Tensor) -> torch.Tensor:
        if self.kind == "FBP":
            return fbp_convert_fast(pj, self.fbp_geom)
        return sart_fast_convert(pj, self.fbp_geom, nstart=self.nstart,
                                 ntv=self.ntv, nsubsets=self.nsubsets,
                                 sample_rate=self.sample_rate)

    __call__ = convert

"""Domain-convertor facade: sinogram ↔ image (port of
ipdm_tpu/recon/convertor.py).

``Convertor(kind)(pj)`` maps [B, na, nr] sinograms to [B, n, n] images:
"FBP" through the fast rebinned FBP (recon/fbp_fast.py), "ART" through
the fast OS-SART (recon/sart_fast.py: ``nstart`` sweeps over ``nsubsets``
ordered subsets, every ``sample_rate``-th view), "TV" as ART with at least
one TV step per sweep. ``exact_fbp`` / ``exact_art`` take the
reference-faithful paths instead: the direct fan-beam FBP
(recon/fbp.py::fbp_convert) and the footprint SART (:func:`recons`).
The scanner is a ``FanBeamGeometry`` (``geom=``, seen through the FBP
parameterisation by :func:`fbp_geom_from_fan`) or an ``FBPGeometry``
given directly (``fbp_geom=``). :func:`recons` and :func:`project` are
the reference's pybind surface (recons_torch / proj_torch,
TASART2DNSL0_PyAPI.cpp:33-90), with the recons output transpose
(permute(0,2,1), PyAPI.cpp:52-54).
"""

from __future__ import annotations

from typing import Optional

import torch

from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry, fbp_convert
from ipdm_tpu_torch.recon.fbp_fast import fbp_convert_fast
from ipdm_tpu_torch.recon.geometry import (SIEMENS, FanBeamGeometry,
                                           area_lut, default_betas)
from ipdm_tpu_torch.recon.projector import forward_project_batch
from ipdm_tpu_torch.recon.sart import sart_reconstruct
from ipdm_tpu_torch.recon.sart_fast import sart_fast_convert


def recons(proj: torch.Tensor, geom: FanBeamGeometry = SIEMENS,
           lut=None, betas=None, nstart: int = 10, ntv: int = 0,
           nsubsets: int = 40, sample_rate: int = 1,
           permute: bool = True) -> torch.Tensor:
    """ART/TV reconstruction of [B, na, nr] sinograms → [B, ny, nx] images
    (recons_torch, TASART2DNSL0_PyAPI.cpp:33-57): nstart SART sweeps, ntv
    TV steps per sweep, optional view subsampling, and the output
    transpose the binding applies (``permute``). ``lut`` / ``betas``
    default to the geometry's analytic LUT and uniform view angles."""
    if lut is None:
        lut = area_lut(geom)
    if betas is None:
        betas = default_betas(geom)
    out = sart_reconstruct(proj, geom, lut, betas, nstart=nstart, ntv=ntv,
                           nsubsets=nsubsets, sample_rate=sample_rate)
    if permute:
        out = out.transpose(1, 2)
    return out


def project(volume: torch.Tensor, geom: FanBeamGeometry = SIEMENS,
            lut=None, betas=None) -> torch.Tensor:
    """Forward projection of [B, ny, nx] images → [B, na, nr] sinograms
    (proj_torch, TASART2DNSL0_PyAPI.cpp:63-80). The binding reads the
    volume without the recons transpose, so a caller holding images in the
    recons (permuted) convention passes ``volume.transpose(1, 2)``."""
    if lut is None:
        lut = area_lut(geom)
    if betas is None:
        betas = default_betas(geom)
    return forward_project_batch(volume, geom, lut, betas)


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
                 ntv: int = 0, nsubsets: int = 40, sample_rate: int = 1,
                 exact_fbp: bool = False, exact_art: bool = False):
        if kind not in ("FBP", "ART", "TV"):
            raise ValueError(f"convertor {kind!r}: 'FBP', 'ART' or 'TV'")
        self.kind = kind
        self.geom = geom
        if fbp_geom is None:
            fbp_geom = (SIEMENS_FBP if geom is SIEMENS
                        else fbp_geom_from_fan(geom))
        self.fbp_geom = fbp_geom
        self.exact_fbp = exact_fbp
        self.exact_art = exact_art
        # the subset count divides the view count (convertor.py:96-97)
        while nsubsets > 1 and self.fbp_geom.M % nsubsets:
            nsubsets -= 1
        self.nsubsets = nsubsets
        # the exact projector's tables (host numpy; moved to the
        # sinograms' device per call)
        self.lut = area_lut(geom)
        self.betas = default_betas(geom)
        self.ntv = ntv if kind != "TV" else max(ntv, 1)
        self.nstart = nstart
        self.sample_rate = sample_rate

    def convert(self, pj: torch.Tensor) -> torch.Tensor:
        if self.kind == "FBP":
            if self.exact_fbp:
                return fbp_convert(pj, self.fbp_geom)
            return fbp_convert_fast(pj, self.fbp_geom)
        if self.exact_art:
            return recons(pj, self.geom, self.lut, self.betas,
                          nstart=self.nstart, ntv=self.ntv,
                          nsubsets=self.nsubsets,
                          sample_rate=self.sample_rate, permute=True)
        return sart_fast_convert(pj, self.fbp_geom, nstart=self.nstart,
                                 ntv=self.ntv, nsubsets=self.nsubsets,
                                 sample_rate=self.sample_rate)

    def project(self, volume: torch.Tensor) -> torch.Tensor:
        """The exact footprint FP of [B, ny, nx] images (proj_torch)."""
        return project(volume, self.geom, self.lut, self.betas)

    __call__ = convert

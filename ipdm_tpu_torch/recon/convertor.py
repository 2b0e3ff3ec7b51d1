"""Domain-convertor facade: sinogram → image (port of
ipdm_tpu/recon/convertor.py:71-124, the fast paths).

``Convertor(kind)(pj)`` maps [B, na, nr] sinograms to [B, n, n] images:
"FBP" through the fast rebinned FBP (recon/fbp_fast.py), "ART" through
the fast OS-SART (recon/sart_fast.py: ``nstart`` sweeps over ``nsubsets``
ordered subsets, every ``sample_rate``-th view), "TV" as ART with at least
one TV step per sweep. The reference-faithful exact FBP and footprint SART
(``exact_fbp`` / ``exact_art``) are ported with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry
from ipdm_tpu_torch.recon.fbp_fast import fbp_convert_fast
from ipdm_tpu_torch.recon.sart_fast import sart_fast_convert


class Convertor:
    """Callable convertor the denoisers use (reference init_convertor,
    Utils/train_test_utils.py:225-233)."""

    def __init__(self, kind: str, fbp_geom: Optional[FBPGeometry] = None, *,
                 nstart: int = 10, ntv: int = 0, nsubsets: int = 40,
                 sample_rate: int = 1):
        if kind not in ("FBP", "ART", "TV"):
            raise ValueError(f"convertor {kind!r}: 'FBP', 'ART' or 'TV'")
        self.kind = kind
        self.fbp_geom = SIEMENS_FBP if fbp_geom is None else fbp_geom
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

"""Domain-convertor facade: sinogram → image (port of
ipdm_tpu/recon/convertor.py, FBP kind).

``Convertor("FBP").convert(pj)`` maps [B, na, nr] sinograms to [B, n, n]
images through the fast rebinned FBP (recon/fbp_fast.py) with the
reference's detector-flip convention. The ART/TV convert (OS-SART,
``recon/sart_fast.py``) comes with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry
from ipdm_tpu_torch.recon.fbp_fast import fbp_convert_fast


class Convertor:
    """Callable convertor the denoisers use (reference init_convertor,
    Utils/train_test_utils.py:225-233)."""

    def __init__(self, kind: str, fbp_geom: Optional[FBPGeometry] = None):
        if kind in ("ART", "TV"):
            raise NotImplementedError(
                f"convertor {kind!r} (OS-SART) is ported with the ART slice; "
                "this slice converts with FBP")
        if kind != "FBP":
            raise ValueError(f"convertor {kind!r}: 'FBP', 'ART' or 'TV'")
        self.kind = kind
        self.fbp_geom = SIEMENS_FBP if fbp_geom is None else fbp_geom

    def convert(self, pj: torch.Tensor) -> torch.Tensor:
        return fbp_convert_fast(pj, self.fbp_geom)

    __call__ = convert

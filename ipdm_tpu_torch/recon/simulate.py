"""Low-dose CT simulation: dose-reduction noise in the log-sinogram domain
(port of ipdm_tpu/recon/simulate.py).

The reference simulator's compound-Poisson Gaussian approximation with
electronic noise Ne = 5.8 and photon flux N0 = 1.4e5,

    σ²(p) = (1−f)·exp(p)·(1 + (1+f)·Ne·exp(p)/(f·N0)) / (f·N0)

applied as p + σ(p)·n, n ~ N(0,1), on the sinogram's device, with the
low-dose image reconstructed by the fast OS-SART. The ``exact=True`` branch
(the fan-beam footprint SART) is ported with the exact physics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
from ipdm_tpu_torch.recon.geometry import SIEMENS, FanBeamGeometry
from ipdm_tpu_torch.recon.sart_fast import sart_fast_convert

NE = 5.8
N0 = 1.4e5


def add_noise(data: torch.Tensor, generator: Optional[torch.Generator],
              factor: float = 0.5) -> torch.Tensor:
    """Noisy low-dose sinogram at dose ``factor``. data: any shape; the
    generator lives on data's device (None: the device's default
    generator)."""
    n = torch.randn(data.shape, generator=generator, dtype=data.dtype,
                    device=data.device)
    e = torch.exp(data)
    var = (1 - factor) * e * (1 + ((1 + factor) * NE * e) / (factor * N0)) \
        / (factor * N0)
    return data + torch.sqrt(var) * n


def simulate_ldct_batch(clean_proj: torch.Tensor,
                        generator: Optional[torch.Generator],
                        dose: float = 0.25,
                        geom: FanBeamGeometry = SIEMENS, nstart: int = 10,
                        nsubsets: int = 40, exact: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, na, nr] clean sinograms → (noisy sinograms, LD images
    [B, ny, nx])."""
    if exact:
        raise NotImplementedError(
            "the exact footprint SART is ported with the exact physics")
    noisy = add_noise(clean_proj, generator, dose)
    ld_img = sart_fast_convert(noisy, fbp_geom_from_fan(geom), nstart=nstart,
                               nsubsets=nsubsets)
    return noisy, ld_img

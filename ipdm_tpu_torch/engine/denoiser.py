"""Progressive dual-domain denoise of one slice (port of the test path of
ipdm_tpu/engine/denoiser.py:637-765).

``progressive_denoiser`` runs the sinogram stage (guided partial diffusion
with the proj UNet, constant or per-pixel λ), one batched convert of the
kept iterations to images (FBP or OS-SART), the FBP sharpen, and the
image stage (guided partial diffusion with the img UNet, plus the ultra
pass). Options come from a plain dict with ``IPDMConfig``'s key names
(``ipdm_tpu/config/config.py``); a key the dict lacks takes IPDMConfig's
default.

Inputs and outputs are NHWC like the JAX engine's ([B, na, nr, 1]
sinograms, [B, 512, 512, 1] images); the UNets run NCHW inside. Checkpoint
loading, data loading, metrics and result saving come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ipdm_tpu_torch import resolve_device
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.diffusion.guided import guided_reverse_process
from ipdm_tpu_torch.ops.lambda_curve import curve_init, proj_curve_init
from ipdm_tpu_torch.ops.sharpen import tensor_sharpen
from ipdm_tpu_torch.recon.convertor import Convertor

# IPDMConfig's defaults (ipdm_tpu/config/config.py:45-125) of the keys
# this module reads with opt.get
_DEFAULTS = dict(ntv=0, ultra_img_denoise=True, sart_subsets=40,
                 sart_nstart=10, sart_sample_rate=1,
                 lambda_ratio_img=5, kernel_size_img=4, amplitude_img=20,
                 lambda_ratio_proj=5, kernel_size_proj=4, amplitude_proj=5)


def _opt(opt: dict, key: str):
    return opt.get(key, _DEFAULTS[key])


def make_convertor(opt: dict) -> Convertor:
    """The convertor the options name, with the OS-SART settings
    (engine init_convertor, denoiser.py:288-293)."""
    return Convertor(opt["convertor"], nstart=_opt(opt, "sart_nstart"),
                     ntv=_opt(opt, "ntv"), nsubsets=_opt(opt, "sart_subsets"),
                     sample_rate=_opt(opt, "sart_sample_rate"))


def diffusion_for(opt: dict, domain: str, device=None) -> GaussianDiffusion:
    """The domain's cosine-schedule diffusion (engine init_*_model)."""
    return GaussianDiffusion(timesteps=opt[f"timesteps_{domain}"],
                             beta_schedule="cosine",
                             schedule_power=opt[f"schedule_power_{domain}"],
                             device=device)


def _as_nchw(x, device) -> torch.Tensor:
    """NHWC array or tensor → contiguous f32 NCHW tensor on ``device``."""
    x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                        dtype=torch.float32, device=device)
    return x.permute(0, 3, 1, 2).contiguous()


def _guided(opt, domain, model, gd, x, generator, curve, **kw):
    if opt[f"sample_method_{domain}"] != "dense":
        raise NotImplementedError(
            "sparse (DDIM) sampling is ported with a later slice")
    return guided_reverse_process(
        model, gd, x, generator, t_start=opt[f"t_start_{domain}"],
        clip=opt[f"clip_{domain}"], mode=domain,
        eta=opt[f"eta_{domain}"],
        constant_guidance=opt[f"constant_guidance_{domain}"],
        lambda_ratio=_opt(opt, f"lambda_ratio_{domain}"),
        kernel_size=_opt(opt, f"kernel_size_{domain}"),
        amplitude=_opt(opt, f"amplitude_{domain}"), lambda_curve=curve,
        **kw)


@torch.inference_mode()
def proj_denoiser(opt: dict, model, x, generator: torch.Generator,
                  convertor: Optional[Convertor] = None,
                  device=None):
    """Sinogram stage and convert (denoiser.py:637-692). x: NHWC
    [B, na, nr, 1]. Every kept iteration is converted in one batch (the
    convert acts per item, so stacking is exact). Returns the last one's
    image, NHWC [B, n, n, 1], and the noise class the adaptive schedule
    chose (None unless ``t_start_proj`` is None)."""
    dev = resolve_device(device)
    result, noise_strength = _guided(
        opt, "proj", model, diffusion_for(opt, "proj", dev),
        _as_nchw(x, dev), generator, proj_curve_init())
    if convertor is None:
        convertor = make_convertor(opt)
    G = 10.0 if opt["clip_proj"] else 1.0  # un-scale (/10 load convention)
    B = result[0].shape[0]
    conv = convertor(torch.cat([G * r[:, 0] for r in result], dim=0))
    return conv[-B:, :, :, None], noise_strength


@torch.inference_mode()
def img_denoiser(opt: dict, model, x, generator: torch.Generator,
                 noise_strength: Optional[str] = None,
                 device=None) -> torch.Tensor:
    """Image stage (denoiser.py:694-742), NHWC in and out; the input is
    also the stage's ``ldct`` term, and ``noise_strength`` (the sinogram
    stage's noise class) picks the adaptive schedule when ``t_start_img``
    is None. Runs the ultra pass (3×5 steps at λ=0.6, η=0.6) when
    ``ultra_img_denoise``."""
    dev = resolve_device(device)
    xc = _as_nchw(x, dev)
    gd = diffusion_for(opt, "img", dev)
    curve = curve_init()
    result, _ = _guided(opt, "img", model, gd, xc, generator, curve,
                        noise_strength=noise_strength, ldct=xc)
    if _opt(opt, "ultra_img_denoise"):
        result, _ = guided_reverse_process(
            model, gd, result[-1], generator, t_start=[5, 5, 5],
            clip=opt["clip_img"], eta=0.6, mode="img",
            constant_guidance=0.6, ldct=xc)
    return result[-1].permute(0, 2, 3, 1)


@torch.inference_mode()
def progressive_denoiser(opt: dict, proj_model, img_model, ldproj,
                         generator: torch.Generator,
                         convertor: Optional[Convertor] = None,
                         sharpen_num: int = 42, device=None) -> torch.Tensor:
    """proj stage → convert → (sharpen) → img stage (denoiser.py:744-765).
    ldproj: NHWC [B, na, nr, 1]. The convertor defaults to the one the
    options name (:func:`make_convertor`). Returns the denoised image NHWC
    [B, n, n, 1] in f32."""
    if opt.get("normal", False):
        raise NotImplementedError(
            "the Yeo-Johnson normalisation is ported with a later slice")
    img, noise_strength = proj_denoiser(opt, proj_model, ldproj, generator,
                                        convertor=convertor, device=device)
    if not (opt["convertor"] == "FBP" and opt.get("fbp_sharpen", False)):
        sharpen_num = -1
    x = tensor_sharpen(img, sharpen_num)
    return img_denoiser(opt, img_model, x, generator,
                        noise_strength=noise_strength, device=device)

"""The whole slice at a small size, zero noise on both sides: the port's
progressive_denoiser against the JAX pipeline composed as
bench.py:204-241 composes it, in FBP mode (proj guided at constant λ →
batched fbp_convert_fast of the kept iterations → the last →
tensor_sharpen 70 → img guided) and in ART mode (proj guided with the
per-pixel λ after a probe → batched sart_fast_convert → the last → img
guided → the ultra pass), with the image stage's ldct term taken from its
input as the JAX engine does (ipdm_tpu/engine/denoiser.py:699-700)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ipdm_tpu.diffusion.diffusion import GaussianDiffusion as JaxDiffusion
from ipdm_tpu.diffusion.guided import \
    guided_reverse_process as jax_guided
from ipdm_tpu.ops.lambda_curve import proj_curve_init
from ipdm_tpu.ops.sharpen import tensor_sharpen as jax_sharpen
from ipdm_tpu.recon.fbp import FBPGeometry as JaxGeometry
from ipdm_tpu.recon.fbp_fast import fbp_convert_fast as jax_fbp
from ipdm_tpu.recon.sart_fast import sart_fast_convert as jax_sart
from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
from ipdm_tpu_torch.recon.convertor import Convertor
from ipdm_tpu_torch.recon.fbp import FBPGeometry
from tests.test_torch_guided import tiny_pair, zero_noise  # noqa: F401

# 90 views of 64 detectors onto a 32² grid: the sinogram UNet's middle
# attention (45×32 tokens) stays small on the CPU
GEOM = dict(n_det=64, n_views=90, grid_n=32, grid_l=21.0,
            da=0.0010125 * 912 / 64, det_offset=3.75, view_step_deg=4.0)
# a fractional stem, as the sinogram UNet has: its units take planar_unit
PROJ_TINY = dict(in_channels=1, model_channels=16, out_channels=1,
                 num_res_blocks=1, attention_resolutions=(4,),
                 channel_mult=(0.5, 1, 1), num_heads=2)
IMG_TINY = dict(in_channels=1, model_channels=8, out_channels=1,
                num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), num_heads=2)
T_START = [2, 2, 2]
OPT = dict(convertor="FBP", fbp_sharpen=True, ultra_img_denoise=False,
           timesteps_proj=1000, schedule_power_proj=1, t_start_proj=T_START,
           clip_proj=False, eta_proj=0.4, constant_guidance_proj=0.5,
           sample_method_proj="dense",
           timesteps_img=1000, schedule_power_img=1, t_start_img=T_START,
           clip_img=True, eta_img=0.7, constant_guidance_img=0.45,
           sample_method_img="dense")


def test_fbp_mode_slice_matches_jax(zero_noise):  # noqa: F811
    jproj, proj = tiny_pair(PROJ_TINY, seed=1)
    jimg, img = tiny_pair(IMG_TINY, seed=2)
    ld_proj = (np.random.default_rng(3).random((1, 90, 64, 1))
               .astype(np.float32) * 4.0)

    key = jax.random.PRNGKey(0)
    iters, _, _ = jax_guided(jproj, JaxDiffusion(1000, "cosine"),
                             jnp.asarray(ld_proj), key, t_start=T_START,
                             clip=False, eta=0.4, mode="proj",
                             constant_guidance=0.5)
    stacked = jnp.concatenate([p[..., 0] for p in iters], axis=0)
    x = jax_fbp(stacked, JaxGeometry(**GEOM))[-1:][..., None]
    x = jax_sharpen(x, 70)
    out, _, _ = jax_guided(jimg, JaxDiffusion(1000, "cosine"), x, key,
                           t_start=T_START, clip=True, eta=0.7, mode="img",
                           constant_guidance=0.45, ldct=x)
    want = np.asarray(out[-1])

    got = progressive_denoiser(OPT, proj, img, ld_proj, None,
                               convertor=Convertor("FBP",
                                                   FBPGeometry(**GEOM)),
                               sharpen_num=70, device="cpu")
    assert got.shape == (1, 32, 32, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)

# the Mayo preset's ART-mode settings (Config/Mayo-Config/
# test_progressive_option.json): per-pixel proj λ, no sharpen, ultra pass
ART_OPT = dict(OPT, convertor="ART", ultra_img_denoise=True,
               constant_guidance_proj=None, eta_proj=0.5,
               lambda_ratio_proj=1, kernel_size_proj=4, amplitude_proj=7)


def test_art_mode_slice_matches_jax(zero_noise):  # noqa: F811
    jproj, proj = tiny_pair(PROJ_TINY, seed=1)
    jimg, img = tiny_pair(IMG_TINY, seed=2)
    ld_proj = (np.random.default_rng(3).random((1, 90, 64, 1))
               .astype(np.float32) * 4.0)

    key = jax.random.PRNGKey(0)
    gd = JaxDiffusion(1000, "cosine")
    iters, _, _ = jax_guided(jproj, gd, jnp.asarray(ld_proj), key,
                             t_start=T_START, clip=False, eta=0.5,
                             mode="proj", constant_guidance=None,
                             lambda_ratio=1, lambda_curve=proj_curve_init(),
                             kernel_size=4, amplitude=7)
    assert len(iters) == 4          # probe, two map-λ iterations, ensemble
    stacked = jnp.concatenate([p[..., 0] for p in iters], axis=0)
    x = jax_sart(stacked, JaxGeometry(**GEOM), nstart=2,
                 nsubsets=6)[-1:][..., None]
    out, _, _ = jax_guided(jimg, gd, x, key, t_start=T_START, clip=True,
                           eta=0.7, mode="img", constant_guidance=0.45,
                           ldct=x)
    out, _, _ = jax_guided(jimg, gd, out[-1], key, t_start=[5, 5, 5],
                           clip=True, eta=0.6, mode="img",
                           constant_guidance=0.6, ldct=x)
    want = np.asarray(out[-1])

    conv = Convertor("ART", FBPGeometry(**GEOM), nstart=2, nsubsets=6)
    got = progressive_denoiser(ART_OPT, proj, img, ld_proj, None,
                               convertor=conv, device="cpu")
    assert got.shape == (1, 32, 32, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)

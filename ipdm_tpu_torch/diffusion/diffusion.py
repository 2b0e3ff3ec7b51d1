"""Gaussian diffusion core: closed-form q/p distributions on precomputed
tables (port of ipdm_tpu/diffusion/diffusion.py).

The tables are computed in float64 with numpy (the reference uses
torch.float64, Model/model.py:385-421) and kept as float32 tensors on the
diffusion's device. The model is passed in as ``model_fn(x, t) -> eps``.
Every Gaussian draw goes through :func:`noise_like`, so a test can replace
that one function to force the noise to zero.
"""

from __future__ import annotations

import numpy as np
import torch

from ipdm_tpu_torch import resolve_device
from ipdm_tpu_torch.diffusion.schedules import make_betas

_TABLES = ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
           "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
           "sqrt_recipm1_alphas_cumprod", "posterior_variance",
           "posterior_log_variance_clipped", "posterior_mean_coef1",
           "posterior_mean_coef2")


def make_tables(timesteps: int, beta_schedule: str,
                schedule_power: float = 1) -> dict:
    """float64 numpy tables with the algebra of reference model.py:385-421."""
    betas = make_betas(timesteps, beta_schedule, schedule_power)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod))
    return dict(
        betas=betas,
        alphas=alphas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(np.clip(posterior_variance,
                                                      1e-20, None)),
        posterior_mean_coef1=(betas * np.sqrt(alphas_cumprod_prev)
                              / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                              / (1.0 - alphas_cumprod)),
    )


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] shaped to broadcast against an ndim-dimensional batch tensor
    (reference _extract, model.py:424-428)."""
    out = a[t]
    return out.reshape(out.shape[:1] + (1,) * (ndim - 1))


def std_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean)/std over the whole tensor, with Bessel's correction like
    the reference's torch.std (model.py:489-490)."""
    mean = x.mean()
    var = ((x - mean) ** 2).sum() / max(x.numel() - 1, 1)
    return (x - mean) / torch.sqrt(var)


def noise_like(x: torch.Tensor, generator) -> torch.Tensor:
    """Standard normal noise of x's shape, dtype and device from
    ``generator``: the one place the samplers draw randomness."""
    return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)


class GaussianDiffusion:
    """Schedule tables on one device plus the reference's q/p methods
    (q_sample, q_sample_inverse, q_posterior_mean_variance,
    predict_start_from_noise, p_mean_variance_condition,
    p_sample_condition, train_loss). The guided sampler lives in
    diffusion/guided.py."""

    def __init__(self, timesteps: int = 1000, beta_schedule: str = "linear",
                 schedule_power: float = 1, device=None):
        self.timesteps = timesteps
        self.beta_schedule = beta_schedule
        self.schedule_power = schedule_power
        self.device = resolve_device(device)
        tables = make_tables(timesteps, beta_schedule, schedule_power)
        for name in _TABLES:
            setattr(self, name, torch.as_tensor(tables[name],
                                                dtype=torch.float32,
                                                device=self.device))

    # -- forward process ----------------------------------------------------

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_sample_inverse(self, x_t, x_start, t):
        """The noise that maps x_start to x_t: the guidance 'condition
        noise' (reference model.py:447-450)."""
        nd = x_start.ndim
        return ((x_t - extract(self.sqrt_alphas_cumprod, t, nd) * x_start)
                / extract(self.sqrt_one_minus_alphas_cumprod, t, nd))

    # -- posterior -----------------------------------------------------------

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (extract(self.posterior_mean_coef1, t, nd) * x_start
                + extract(self.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(self.posterior_variance, t, nd),
                extract(self.posterior_log_variance_clipped, t, nd))

    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.ndim
        return (extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    # -- reverse steps -------------------------------------------------------

    def p_mean_variance_condition(self, model_fn, x_t, x_0, t, lambda_,
                                  clip_denoised=False):
        """Guided mean/variance: ε ← std((1-λ)·std(ε̂) + λ·std(ε_cond))
        (reference model.py:492-502)."""
        pred_noise = model_fn(x_t, t)
        condition_noise = self.q_sample_inverse(x_t, x_0, t).to(
            pred_noise.dtype)
        pred_noise = std_normalize((1.0 - lambda_) * std_normalize(pred_noise)
                                   + lambda_ * std_normalize(condition_noise))
        x_recon = self.predict_start_from_noise(x_t, t, pred_noise)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        return self.q_posterior_mean_variance(x_recon, x_t, t)

    def p_sample_condition(self, model_fn, x_t, x_0, t, generator,
                           clip_denoised=True, lambda_=1.0):
        """One guided ancestral step x_t → x_{t-1} (reference
        model.py:505-515)."""
        mean, _, log_variance = self.p_mean_variance_condition(
            model_fn, x_t, x_0, t, lambda_, clip_denoised=clip_denoised)
        noise = noise_like(x_t, generator)
        nonzero = (t != 0).to(x_t.dtype).reshape(
            (-1,) + (1,) * (x_t.ndim - 1))
        return mean + nonzero * torch.exp(0.5 * log_variance) * noise

    # -- training ------------------------------------------------------------

    def train_loss(self, model_fn, x_start, t, noise):
        """MSE(ε, ε̂) at the given t and noise (reference train_losses,
        model.py:645-652; ipdm_tpu diffusion.py:195-201, which draws the
        noise itself: here the caller draws it)."""
        x_noisy = self.q_sample(x_start, t, noise)
        predicted = model_fn(x_noisy, t)
        return torch.mean((noise - predicted) ** 2)

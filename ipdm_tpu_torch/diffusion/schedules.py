"""DDPM beta schedules, precomputed in float64 (as the reference does with
torch.float64 — Model/model.py:315-373) then consumed as float32 on device.

A copy of ipdm_tpu/diffusion/schedules.py: the port imports nothing of the
JAX package.

All schedule math is plain numpy; diffusion/diffusion.py turns the
tables into float32 tensors on its device.
"""

from __future__ import annotations

import math

import numpy as np


def linear_beta_schedule(timesteps: int, schedule_power: float = 1) -> np.ndarray:
    """Scaled-linear schedule (reference model.py:315-319)."""
    scale = 1000.0 / timesteps
    beta_start = scale * 0.0001
    beta_end = scale * 0.02
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64) ** schedule_power


def sigmoid_beta_schedule(timesteps: int, schedule_power: float = 1) -> np.ndarray:
    """Sigmoid schedule (reference model.py:322-325). Note: like the
    reference, this returns timesteps+1 raw sigmoid values, not betas; it is
    unused by shipped configs and kept for API parity."""
    steps = timesteps + 1
    x = np.linspace(-steps / schedule_power, steps / schedule_power, steps,
                    dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-x))


def cosine_beta_schedule(timesteps: int, s: float = 0.008,
                         schedule_power: float = 1) -> np.ndarray:
    """Cosine schedule of Nichol & Dhariwal (2102.09672), with the reference's
    extra `schedule_power` exponent on ᾱ (model.py:366-372)."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = (np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
                      ) ** schedule_power
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


def make_betas(timesteps: int, beta_schedule: str, schedule_power: float = 1
               ) -> np.ndarray:
    if beta_schedule == "linear":
        return linear_beta_schedule(timesteps, schedule_power)
    if beta_schedule == "cosine":
        return cosine_beta_schedule(timesteps, schedule_power=schedule_power)
    raise ValueError(f"unknown beta schedule {beta_schedule}")


def condition_lambda_ratio(idx: int, timesteps: int, s: float = 0.008,
                           lambda_: float = 1.0) -> float:
    """Scalar per-step guidance-decay ratio (reference model.py:354-363).

    beta = 1 - (ᾱ(idx+1)/ᾱ(idx)) with ᾱ raised to `lambda_`, clipped to
    [0.3, 0.999]. The per-pixel vectorized variant (lambda_map) is ported
    with the adaptive-λ slice."""
    x = np.array([0, idx, idx + 1], dtype=np.float64)
    alphas_cumprod = (np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
                      ) ** lambda_
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[2] / alphas_cumprod[1])
    return float(np.clip(betas, 0.3, 0.999))

"""Guided partial-diffusion sampler: the algorithmic core of IPDM (port of
ipdm_tpu/diffusion/guided.py).

Each outer iteration q-samples the current estimate to step ``ts``, runs
the reverse loop with the guided step ``p_sample_condition`` (one UNet
eval per timestep) and clamps the result; between iterations the guidance
image is updated (reference Model/model.py:518-642):

* proj mode: ``g = η·x̂ + (1−η)·x₀``;
* img mode:  ``g = η·x̂ + (0.95−η)·x₀ + 0.05·ldct``.

λ per step is a constant (``constant_guidance``) or, when that is None,
comes from a probe iteration: the probe runs with the cosine λ table, its
residual against the condition gives a per-pixel exponent map
(``_compute_delt``), and the remaining iterations restart from the clean
condition with the per-pixel map ``condition_lambda_map`` (guided.py:304-373).
With ``t_start=None`` the schedule is chosen from the residual
(``_IMG_ADAPTIVE`` / ``_PROJ_ADAPTIVE``; proj mode reads one scalar back
to pick its noise class) and the probe is dropped from the result.

The final 2-tap ensemble ``(x̂_last + x̂_prev)/2`` is appended. The JAX
package scans the loops on device; here they are Python loops over eager
PyTorch. Every Gaussian draw goes through
:func:`ipdm_tpu_torch.diffusion.diffusion.noise_like` with the caller's
``torch.Generator``.

The sparse path (:func:`sparse_guided_reverse_process`, guided.py:489-562,
reference model.py:655-759) q-samples the condition once and runs one
conditioned DDIM pass (:func:`ddim_sample`) per entry of ``t_start``, with
λ on a linear ramp and the condition blended towards each result; it
keeps no ensemble.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ipdm_tpu_torch.data.units import miu2pixel
from ipdm_tpu_torch.diffusion import diffusion as _diffusion
from ipdm_tpu_torch.diffusion.diffusion import (GaussianDiffusion, extract,
                                                std_normalize)
from ipdm_tpu_torch.diffusion.schedules import cosine_beta_schedule
from ipdm_tpu_torch.ops.lambda_map import (avg_pool, condition_lambda_map,
                                           nearest_upsample)


def _torch_median(x: torch.Tensor) -> torch.Tensor:
    """The (n-1)//2-th order statistic of all of x: the lower median for
    an even count, as torch.median returns it (guided.py:42-46)."""
    return x.reshape(-1).median()


def _compute_delt(x_denoised, x_input, mode: str, kernel_size: int,
                  amplitude: float, lambda_curve):
    """Residual-driven per-pixel λ exponent map after the probe iteration
    (guided.py:49-69, reference model.py:574-614). Returns the pooled map
    [B, C, h, w] and, in proj mode, its max (the noise-class statistic;
    None in img mode). The two modes take the median and pool in
    opposite orders, as the reference does."""
    if mode == "img":
        delt = (miu2pixel(x_denoised) - miu2pixel(x_input)).abs()
        delt = avg_pool(delt, kernel_size)
        delt = (delt - _torch_median(delt)).clamp_min(0.0)
        return lambda_curve(torch.exp(amplitude * delt)), None
    delt = (x_denoised - x_input).abs()
    delt = delt - _torch_median(delt)
    delt = avg_pool(delt, kernel_size).clamp_min(0.0)
    delt = torch.exp(amplitude * delt)
    return lambda_curve(delt), delt.max()


# adaptive schedules (reference model.py:584-613): (t_start, eta[, _])
_IMG_ADAPTIVE = {"high": ([15, 15, 15], 0.6, 0.4),
                 "mid": ([15, 12, 10], 0.55, 0.45),
                 "low": ([10, 10, 10], 0.5, 0.5),
                 None: ([10, 10, 10], 0.5, 0.5)}
_PROJ_ADAPTIVE = {"high": ([30, 25, 20], 0.6),
                  "mid": ([20, 18, 15], 0.5),
                  "low": ([15, 15, 15], 0.5)}


def _one_iteration(model_fn, gd: GaussianDiffusion, ts: int, mode: str,
                   clip: bool, lam_fn: Callable, x, guidance, generator):
    """q_sample to ts, reverse loop to 0, post-clamp: one outer iteration
    (guided.py:165-190). ``lam_fn(i)`` is step i's λ: a float or a
    [B, 1, H, W] map."""
    B = x.shape[0]
    t_vec = torch.full((B,), ts, dtype=torch.long, device=x.device)
    x = gd.q_sample(x, t_vec, _diffusion.noise_like(x, generator))
    for i in range(ts - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=x.device)
        x = gd.p_sample_condition(model_fn, x, guidance, t, generator,
                                  clip_denoised=clip, lambda_=lam_fn(i))
    if clip:
        x = x.clamp(0.0, 1.0) if mode == "img" else x.clamp_min(0.0)
    return x


def _guidance_update(mode: str, eta: float, x, x0, ldct):
    """Guidance image for the next iteration (reference model.py:622-635)."""
    if mode == "proj":
        return eta * x + (1 - eta) * x0
    base = x0 if ldct is None else ldct
    return eta * x + (0.95 - eta) * x0 + 0.05 * base


def _iterate(model_fn, gd, ts_list, mode, clip, eta, lam_for, x0, ldct,
             generator) -> List[torch.Tensor]:
    """Iterations from the clean condition x0 (guidance x0 at first), λ
    from ``lam_for(ts)`` (guided.py:273-298)."""
    x = guidance = x0
    results = []
    for ts in ts_list:
        x = _one_iteration(model_fn, gd, int(ts), mode, clip,
                           lam_for(int(ts)), x, guidance, generator)
        results.append(x)
        guidance = _guidance_update(mode, eta, x, x0, ldct)
    return results


@torch.no_grad()
def guided_reverse_process(model_fn: Callable, gd: GaussianDiffusion,
                           img: torch.Tensor,
                           generator: Optional[torch.Generator],
                           t_start: Optional[Sequence[int]] = None,
                           clip: bool = True, lambda_ratio: float = 1,
                           eta: float = 0.5, mode: str = "img",
                           constant_guidance: Optional[float] = None,
                           lambda_curve=None, kernel_size: int = 4,
                           amplitude: float = 20.0,
                           noise_strength: Optional[str] = None,
                           ldct: Optional[torch.Tensor] = None,
                           only_convertor: bool = False
                           ) -> Tuple[List[torch.Tensor], Optional[str]]:
    """Iterative guided reverse process (guided.py:376-477).

    img: the condition, in the layout ``model_fn`` takes (the port's UNets:
    [B, C, H, W]). Returns ``(img_iters, noise_strength)`` like the JAX
    function (without its saved reverse states): with a constant λ or a
    static ``t_start`` the ``len(t_start)`` iterations and the ensemble;
    with ``t_start=None`` the iterations after the probe and the ensemble,
    and in proj mode the noise class the probe chose. ``only_convertor``
    (the engine's ``benchmark_test``) runs no diffusion and returns the
    condition as the one iteration."""
    if mode not in ("img", "proj"):
        raise ValueError(f"mode {mode!r}: 'img' or 'proj'")
    if only_convertor:
        return [img], None
    x0 = img
    out_noise_strength = None
    if constant_guidance is not None:
        lam = float(constant_guidance)
        iters = _iterate(model_fn, gd, t_start or [20], mode, clip, eta,
                         lambda ts: (lambda i: lam), x0, ldct, generator)
    else:
        if lambda_curve is None:
            raise ValueError("per-pixel lambda (constant_guidance=None) "
                             "needs a lambda_curve")
        adaptive = t_start is None
        probe_ts = 20 if adaptive else int(t_start[0])
        cos_table = cosine_beta_schedule(
            probe_ts, schedule_power=lambda_ratio).astype(np.float32)
        probe = _one_iteration(model_fn, gd, probe_ts, mode, clip,
                               lambda i: float(cos_table[i]), x0, x0,
                               generator)
        delt, dmax = _compute_delt(probe, x0, mode, int(kernel_size),
                                   float(amplitude), lambda_curve)
        if not adaptive:
            sched = [int(t) for t in t_start[1:]]
        elif mode == "img":
            sched, eta, _ = _IMG_ADAPTIVE[noise_strength]
        else:
            dmax_f = float(dmax)  # the one host read per slice
            out_noise_strength = ("high" if dmax_f >= 30 else
                                  "mid" if dmax_f >= 4.5 else "low")
            sched, eta = _PROJ_ADAPTIVE[out_noise_strength]
        size = (x0.shape[2], x0.shape[3])

        def lam_for(ts):
            return lambda i: nearest_upsample(
                condition_lambda_map(delt, i, ts), size)

        # probe restart (model.py:629-630): the map-λ iterations start
        # from the clean condition with guidance = the clean condition
        iters = [probe] + _iterate(model_fn, gd, sched, mode, clip, eta,
                                   lam_for, x0, ldct, generator)
    if len(iters) > 1:
        iters.append((iters[-1] + iters[-2]) / 2)
    if constant_guidance is None and t_start is None:
        iters = iters[1:]  # drop the probe iteration
    return iters, out_noise_strength


# ---------------------------------------------------------------------------
# Sparse (DDIM) sampling (guided.py:489-562, reference model.py:655-759)
# ---------------------------------------------------------------------------


def ddim_sample(model_fn: Callable, gd: GaussianDiffusion,
                sample_img: torch.Tensor, condition: torch.Tensor,
                t_start: int, condition_lambda: float,
                generator: Optional[torch.Generator],
                ddim_timesteps: int = 2, ddim_eta: float = 0.0,
                clip_denoised: bool = True) -> torch.Tensor:
    """Conditioned DDIM over a uniform sub-sequence of ``t_start`` steps
    (reference model.py:655-724, 'uniform' discretisation): the ε blend of
    the guided step, then the DDIM update with σ overridden by
    η·posterior_variance, as the reference does (model.py:713)."""
    seq = np.linspace(t_start - 1, 0, ddim_timesteps + 1).astype(int)[:-1]
    prev_seq = np.append(seq[1:], 0)
    B = sample_img.shape[0]
    dev = sample_img.device
    lam = condition_lambda
    x = sample_img
    for i in range(ddim_timesteps):
        t = torch.full((B,), int(seq[i]), dtype=torch.long, device=dev)
        pt = torch.full((B,), int(prev_seq[i]), dtype=torch.long, device=dev)
        nd = x.ndim
        ac_t = extract(gd.alphas_cumprod, t, nd)
        ac_prev = extract(gd.alphas_cumprod, pt, nd)
        pred_noise = model_fn(x, t)
        cond_noise = gd.q_sample_inverse(x, condition, t).to(pred_noise.dtype)
        pred_noise = std_normalize((1 - lam) * std_normalize(pred_noise)
                                   + lam * std_normalize(cond_noise))
        pred_x0 = (x - torch.sqrt(1.0 - ac_t) * pred_noise) / torch.sqrt(ac_t)
        if clip_denoised:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
        sigmas_t = ddim_eta * torch.sqrt(
            (1 - ac_prev) / (1 - ac_t) * (1 - ac_t / ac_prev))
        pred_dir = torch.sqrt(1 - ac_prev - sigmas_t ** 2) * pred_noise
        sigmas_t = ddim_eta * extract(gd.posterior_variance, t, nd)
        z = _diffusion.noise_like(x, generator)
        x = torch.sqrt(ac_prev) * pred_x0 + pred_dir + sigmas_t * z
    return x


@torch.no_grad()
def sparse_guided_reverse_process(model_fn: Callable, gd: GaussianDiffusion,
                                  condition: torch.Tensor,
                                  generator: Optional[torch.Generator],
                                  t_start: Sequence[int],
                                  condition_lambda_max: float = 0.5,
                                  condition_lambda_min: float = 0.25,
                                  ddim_timesteps: Sequence[int] = (2,),
                                  ddim_eta: float = 0.0, eta: float = 0.5,
                                  clip_denoised: bool = True
                                  ) -> List[torch.Tensor]:
    """Iterated DDIM with a linear λ ramp (reference model.py:727-759).
    condition: in the layout ``model_fn`` takes. Returns one result per
    entry of ``t_start``. λ_i is the i-th value of ``np.arange(λ_max,
    λ_min − step, −step)``, step (λ_max − λ_min)/n, and after each pass the
    condition becomes η·x̂ + (1 − η)·x₀."""
    B = condition.shape[0]
    t0 = torch.full((B,), int(t_start[0]), dtype=torch.long,
                    device=condition.device)
    sample_img = gd.q_sample(condition, t0,
                             _diffusion.noise_like(condition, generator))
    condition_0 = condition
    n = len(t_start)
    step = (condition_lambda_max - condition_lambda_min) / n
    lambdas = np.arange(condition_lambda_max,
                        condition_lambda_min - step, -step)
    result = []
    for i, t in enumerate(t_start):
        sample_img = ddim_sample(model_fn, gd, sample_img, condition, int(t),
                                 float(lambdas[i]), generator,
                                 ddim_timesteps=int(ddim_timesteps[i]),
                                 ddim_eta=float(ddim_eta),
                                 clip_denoised=clip_denoised)
        condition = eta * sample_img + (1 - eta) * condition_0
        result.append(sample_img)
    return result

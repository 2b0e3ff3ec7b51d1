"""Guided partial-diffusion sampler: the algorithmic core of IPDM (port of
ipdm_tpu/diffusion/guided.py, constant-λ mode).

Each outer iteration q-samples the current estimate to step ``ts``, runs
the reverse loop with the guided step ``p_sample_condition`` (one UNet
eval per timestep) and clamps the result; between iterations the guidance
image is updated (reference Model/model.py:518-642):

* proj mode: ``g = η·x̂ + (1−η)·x₀``;
* img mode:  ``g = η·x̂ + (0.95−η)·x₀ + 0.05·ldct``.

The final 2-tap ensemble ``(x̂_last + x̂_prev)/2`` is appended, so three
iterations return four images. The JAX package scans the loops on device;
here they are Python loops over eager PyTorch. Every Gaussian draw goes
through :func:`ipdm_tpu_torch.diffusion.diffusion.noise_like` with the
caller's ``torch.Generator``.

The adaptive / per-pixel-λ mode (``constant_guidance=None``) comes with
the adaptive-λ slice (``ops/lambda_map.py``, ``ops/lambda_curve.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ipdm_tpu_torch.diffusion import diffusion as _diffusion
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion


def _one_iteration(model_fn, gd: GaussianDiffusion, ts: int, mode: str,
                   clip: bool, lambda_: float, x, guidance, generator):
    """q_sample to ts, reverse loop to 0, post-clamp: one outer iteration
    (guided.py:165-190)."""
    B = x.shape[0]
    t_vec = torch.full((B,), ts, dtype=torch.long, device=x.device)
    x = gd.q_sample(x, t_vec, _diffusion.noise_like(x, generator))
    for i in range(ts - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=x.device)
        x = gd.p_sample_condition(model_fn, x, guidance, t, generator,
                                  clip_denoised=clip, lambda_=lambda_)
    if clip:
        x = x.clamp(0.0, 1.0) if mode == "img" else x.clamp_min(0.0)
    return x


def _guidance_update(mode: str, eta: float, x, x0, ldct):
    """Guidance image for the next iteration (reference model.py:622-635)."""
    if mode == "proj":
        return eta * x + (1 - eta) * x0
    base = x0 if ldct is None else ldct
    return eta * x + (0.95 - eta) * x0 + 0.05 * base


@torch.no_grad()
def guided_reverse_process(model_fn: Callable, gd: GaussianDiffusion,
                           img: torch.Tensor,
                           generator: Optional[torch.Generator],
                           t_start: Optional[Sequence[int]] = None,
                           clip: bool = True, eta: float = 0.5,
                           mode: str = "img",
                           constant_guidance: Optional[float] = None,
                           ldct: Optional[torch.Tensor] = None
                           ) -> List[torch.Tensor]:
    """Iterative guided reverse process in constant-λ mode.

    img: the condition, in the layout ``model_fn`` takes (the port's UNets:
    [B, C, H, W]). Returns the iterations (the JAX function's
    ``img_iters``): ``len(t_start)`` images and the ensemble."""
    if constant_guidance is None:
        raise NotImplementedError(
            "adaptive per-pixel lambda (constant_guidance=None) is ported "
            "with the adaptive-lambda slice (lambda_map, lambda_curve); "
            "this slice runs constant-lambda guidance only")
    if mode not in ("img", "proj"):
        raise ValueError(f"mode {mode!r}: 'img' or 'proj'")
    x0 = img
    x = guidance = img
    results = []
    for ts in (t_start or [20]):
        x = _one_iteration(model_fn, gd, int(ts), mode, clip,
                           float(constant_guidance), x, guidance, generator)
        results.append(x)
        guidance = _guidance_update(mode, eta, x, x0, ldct)
    if len(results) > 1:
        results.append((results[-1] + results[-2]) / 2)
    return results

"""The training step: q_sample → UNet → MSE on ε → backward → Adam (port
of ipdm_tpu/engine/trainer.py).

The reference's recipe (Utils/train_test_utils.py:253-348): Adam(lr,
β=(0.9, 0.999)) with torch's weight decay 1e-5 added to the gradient
(:150, :164), t ~ U[0, partial_timesteps) (:265), inputs clamped to ≥ 0
(:262), MSE on ε. The JAX package runs the step as one jit with donated
state; here it is an eager step on the model's own parameters and the
optimizer's state, and the loss comes back as a device tensor so that the
caller decides when to read it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 1e-5) -> torch.optim.Adam:
    """Adam(lr, β=(0.9, 0.999), eps=1e-8) with wd·θ added to the raw
    gradient before the moments: optax's add_decayed_weights followed by
    adam (trainer.py:31-36), which is torch's own Adam weight decay."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def nhwc_to_nchw(x, device) -> torch.Tensor:
    """NHWC array or tensor → contiguous f32 NCHW tensor on ``device``."""
    x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                        dtype=torch.float32, device=device)
    return x.permute(0, 3, 1, 2).contiguous()


def train_inputs(images, t, noise, partial_timesteps: int,
                 generator: Optional[torch.Generator], device):
    """The step's (x, t, noise), NCHW on ``device``: images NHWC clamped
    to ≥ 0; t [B] integers in [0, partial_timesteps) and noise of the
    images' shape, drawn from ``generator`` (t first, then the noise)
    where not given."""
    x = nhwc_to_nchw(images, device).clamp_min(0.0)
    B = x.shape[0]
    if t is None:
        t = torch.randint(0, partial_timesteps, (B,), generator=generator,
                          device=device)
    else:
        t = torch.as_tensor(np.asarray(t), dtype=torch.long, device=device)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=device)
    else:
        noise = nhwc_to_nchw(noise, device)
    return x, t, noise


def make_train_step(model: torch.nn.Module, gd: GaussianDiffusion,
                    optimizer: torch.optim.Optimizer, partial_timesteps: int,
                    generator: Optional[torch.Generator]) -> Callable:
    """The train step over ``model``'s parameters.

    ``step(images, t=None, noise=None)``: images NHWC [B, H, W, C]
    (patch-flattened), t and noise as :func:`train_inputs` takes them.
    One Adam update; returns the loss, a 0-d tensor on the model's
    device."""
    def train_step(images, t=None, noise=None) -> torch.Tensor:
        x, t, noise = train_inputs(images, t, noise, partial_timesteps,
                                   generator, gd.device)
        optimizer.zero_grad(set_to_none=True)
        loss = gd.train_loss(model, x, t, noise)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def flatten_patches(batch: np.ndarray) -> np.ndarray:
    """[B, patches, H, W, C] → [B·patches, H, W, C] (reference images.view,
    train_test_utils.py:260). Pass-through for unpatched [B, H, W, C]."""
    if batch.ndim == 5:
        return batch.reshape((-1,) + batch.shape[2:])
    return batch

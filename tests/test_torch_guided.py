"""The port's guided_reverse_process against the JAX sampler of
ipdm_tpu/diffusion/guided.py, with a tiny UNet carried across from Flax,
T = 50 timesteps and the noise forced to zero on both sides (as
tests/test_reference_oracle.py:228-237 does): constant λ, and the per-pixel
λ after a cosine-λ probe with a static t_start (img and proj mode) and
with t_start=None (proj mode, which picks a noise class)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.diffusion.diffusion import GaussianDiffusion as JaxDiffusion
from ipdm_tpu.diffusion.guided import \
    guided_reverse_process as jax_guided
from ipdm_tpu.models.unet import UNetModel as FlaxUNet
from ipdm_tpu.ops import lambda_curve as jax_curve
from ipdm_tpu_torch.diffusion import diffusion as port_diffusion
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.diffusion.guided import guided_reverse_process
from ipdm_tpu_torch.models.unet import UNetModel
from ipdm_tpu_torch.ops import lambda_curve
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax

# one level plus the middle block: each JAX sampler compile stays short
TINY = dict(in_channels=1, model_channels=8, out_channels=1,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_heads=2)


@pytest.fixture
def zero_noise(monkeypatch):
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(port_diffusion, "noise_like",
                        lambda x, generator: torch.zeros_like(x))


def tiny_pair(cfg, seed):
    """A Flax UNet apply function and the port's UNet with the same
    random weights (every leaf N(0, 0.1))."""
    fmodel = FlaxUNet(**cfg)
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 1)),
                            jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)
    params = {"params": jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32),
        shapes["params"])}
    model = UNetModel(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, params))
    return (lambda x, t: fmodel.apply(params, x, t)), model


@pytest.mark.parametrize("mode,t_start,clip,eta,lam", [
    ("img", [3, 3, 3], True, 0.7, 0.45),
    ("proj", [3, 3], False, 0.4, 0.5),
])
def test_constant_lambda_guided_matches_jax(zero_noise, mode, t_start, clip,
                                            eta, lam):
    jfn, model = tiny_pair(TINY, seed=4)
    rng = np.random.default_rng(11)
    x = rng.random((1, 16, 16, 1)).astype(np.float32)
    x = x * (0.8 if mode == "img" else 3.0)
    ldct = (rng.random((1, 16, 16, 1)).astype(np.float32) * 0.8
            if mode == "img" else None)
    want, _, _ = jax_guided(
        jfn, JaxDiffusion(50, "cosine"), jnp.asarray(x),
        jax.random.PRNGKey(0), t_start=t_start, clip=clip, eta=eta,
        mode=mode, constant_guidance=lam,
        ldct=None if ldct is None else jnp.asarray(ldct))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    got, ns = guided_reverse_process(
        model, GaussianDiffusion(50, "cosine", device="cpu"), nchw(x), None,
        t_start=t_start, clip=clip, eta=eta, mode=mode,
        constant_guidance=lam, ldct=None if ldct is None else nchw(ldct))
    assert ns is None
    assert len(got) == len(want) == len(t_start) + 1  # + the ensemble
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4)


def _per_pixel_pair(mode, t_start, amplitude, seed):
    """The JAX and the port's per-pixel-λ runs on the same input (the
    preset's curve, kernel 4, λ ratio 1 for proj and 10 for img)."""
    jfn, model = tiny_pair(TINY, seed=seed)
    rng = np.random.default_rng(seed + 10)
    x = rng.random((1, 16, 16, 1)).astype(np.float32)
    x = x * (0.8 if mode == "img" else 3.0)
    ldct = x if mode == "img" else None
    init = "curve_init" if mode == "img" else "proj_curve_init"
    kw = dict(t_start=t_start, clip=mode == "img", eta=0.5, mode=mode,
              constant_guidance=None, kernel_size=4, amplitude=amplitude,
              lambda_ratio=10 if mode == "img" else 1)
    want, _, want_ns = jax_guided(
        jfn, JaxDiffusion(50, "cosine"), jnp.asarray(x),
        jax.random.PRNGKey(0), lambda_curve=getattr(jax_curve, init)(),
        ldct=None if ldct is None else jnp.asarray(ldct), **kw)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    got, got_ns = guided_reverse_process(
        model, GaussianDiffusion(50, "cosine", device="cpu"), nchw(x), None,
        lambda_curve=getattr(lambda_curve, init)(),
        ldct=None if ldct is None else nchw(ldct), **kw)
    return got, got_ns, want, want_ns


def _assert_iters_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # the λ map's f32 exp/pow over the UNet's f32 sums in another order
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode,amplitude", [("img", 30.0), ("proj", 7.0)])
def test_per_pixel_lambda_static_t_start_matches_jax(zero_noise, mode,
                                                     amplitude):
    """The probe (cosine λ), the restart from the clean condition, two
    map-λ iterations and the ensemble: [probe, it1, it2, ens]."""
    got, got_ns, want, want_ns = _per_pixel_pair(mode, [3, 3, 3], amplitude,
                                                 seed=6)
    assert len(got) == 4 and got_ns is None and want_ns is None
    _assert_iters_close(got, want)


def test_adaptive_lambda_is_the_next_slice(zero_noise):
    """The adaptive mode (t_start=None) matches JAX: the 20-step probe,
    the one host read of the residual max, the noise class and its
    schedule, the map-λ iterations and the ensemble, the probe dropped."""
    got, got_ns, want, want_ns = _per_pixel_pair("proj", None, 1.0, seed=7)
    # amplitude 1 keeps the residual max below 4.5 (2.25 here, with the
    # per-pixel exponents spread over 1.0-20): the "low" class, whose
    # schedule is [15, 15, 15]
    assert got_ns == want_ns == "low"
    assert len(got) == 4
    _assert_iters_close(got, want)

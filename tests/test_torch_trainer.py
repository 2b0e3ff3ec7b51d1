"""The port's training step (ipdm_tpu_torch/engine/trainer.py, through
GaussianDiffusion.train_loss and the UNet's remat) against the JAX
package's make_train_step / train_loss on the CPU.

One tiny UNet (test_torch_grad.py's img-like configuration) with the same
weights on both sides (state_dict_from_flax), the same batch, and the t
and ε that JAX's step draws: they come from the same jax.random splits as
ipdm_tpu/engine/trainer.py:60-64 and are handed to the port explicitly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.diffusion.diffusion import GaussianDiffusion as JaxDiffusion
from ipdm_tpu.engine import trainer as jtrainer
from ipdm_tpu.models.unet import UNetModel as FlaxUNet
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.engine import trainer
from ipdm_tpu_torch.models.unet import UNetModel
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax

IMG_LIKE = dict(in_channels=1, model_channels=40, out_channels=1,
                num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), num_heads=2)
PARTIAL = 50
LR = 1e-3
# weight decay of the Adam comparison: large enough that wd·θ weighs as
# much as the gradients, so a decay left out or applied differently moves
# the parameters past the tolerance (the engine's 1e-5 would not show)
WD = 0.1

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: with the suite's
    workers all on one machine, torch's default of a thread per core makes
    each small op wait on descheduled threads (a 3 s test took 500 s with
    six workers at eight threads each, 12 s at one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _weights(seed):
    model = FlaxUNet(**IMG_LIKE)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 12, 10, 1)),
                            jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.08, a.shape).astype(np.float32),
        shapes["params"])
    return model, {"params": params}


def _draws(rng, B, shape):
    """JAX's t and ε for one step (trainer.py:60-64, diffusion.py:198)."""
    rng_t, rng_n = jax.random.split(rng)
    t = jax.random.randint(rng_t, (B,), 0, PARTIAL)
    noise = jax.random.normal(rng_n, shape, jnp.float32)
    return np.asarray(t), np.asarray(noise)


def _port(fparams, remat=False):
    model = UNetModel(**IMG_LIKE, device="cpu", remat=remat)
    model.load_state_dict(state_dict_from_flax(model, fparams))
    return model


def _close(got, want, name, scale):
    """f32 gradients of a few hundred terms per entry summed in another
    order: test_torch_grad.py's rule, 1e-4 of the tensor's largest entry
    plus 1e-3 of each, plus 1e-5 of the model's largest gradient entry
    (entries whose exact value is zero carry the cancelling terms'
    rounding)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-4 * np.abs(want).max() + 1e-3 * np.abs(want) + 1e-5 * scale
    assert np.all(np.abs(got - want) <= tol), (
        name, float(np.abs(got - want).max()), float(np.abs(want).max()))


@pytest.fixture(scope="module")
def case():
    """The Flax model and weights, a batch, three step keys, and JAX's
    loss and gradient of one step at given parameters and key."""
    fmodel, fparams = _weights(3)
    rng = np.random.default_rng(4)
    # two images, one with negative pixels the step clamps to 0
    images = rng.normal(0.3, 0.5, (2, 13, 11, 1)).astype(np.float32)
    rngs = jax.random.split(jax.random.PRNGKey(7), 3)
    jgd = JaxDiffusion(timesteps=1000, beta_schedule="cosine")

    @jax.jit
    def value_and_grad(params, rng):
        # the step's draws (trainer.py:60-64): train_loss draws its ε
        # from the noise key it is given
        rng_t, rng_n = jax.random.split(rng)
        t = jax.random.randint(rng_t, (2,), 0, PARTIAL)
        return jax.value_and_grad(lambda p: jgd.train_loss(
            lambda x, tt: fmodel.apply(p, x, tt),
            jnp.maximum(jnp.asarray(images), 0.0), t, rng_n))(params)

    return fmodel, fparams, images, rngs, value_and_grad


def test_one_step_loss_and_gradients_match_jax(case):
    fmodel, fparams, images, rngs, value_and_grad = case
    t, noise = _draws(rngs[0], 2, images.shape)
    jloss, jgrads = value_and_grad(fparams, rngs[0])

    model = _port(fparams)
    gd = GaussianDiffusion(timesteps=1000, beta_schedule="cosine",
                           device="cpu")
    x = torch.from_numpy(images).permute(0, 3, 1, 2).clamp_min(0.0)
    loss = gd.train_loss(model, x, torch.from_numpy(t.astype(np.int64)),
                         torch.from_numpy(noise).permute(0, 3, 1, 2))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = state_dict_from_flax(model, {"params": jax.tree_util.tree_map(
        np.asarray, jgrads["params"])})
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name, scale)


def test_three_adam_steps_match_jax_make_train_step(case):
    """Three steps of JAX's jitted make_train_step (Adam with weight decay
    ``WD`` added to the gradient) against three of the port's step with
    JAX's draws. Adam moves each entry by about lr·g/|g| a step, so the
    parameters after three steps agree as far as the gradients' directions
    do: each change θ₃ − θ₀ to 1e-3 of lr plus 1e-3 of itself, plus
    3·lr·min(1, 2ρ), where ρ is the largest relative tolerance of the
    entry's three JAX gradients under the gradient rule of
    :func:`_close` (an entry whose gradient is known to relative ρ has its
    Adam direction known to 2ρ; near 0 its sign is rounding, and three
    steps move an entry by at most 3·lr)."""
    fmodel, fparams, images, rngs, value_and_grad = case
    jgd = JaxDiffusion(timesteps=1000, beta_schedule="cosine")
    tx = jtrainer.make_optimizer(LR, WD)
    state = jtrainer.TrainState(fparams, tx.init(fparams),
                                jnp.zeros((), jnp.int32))
    step = jtrainer.make_train_step(fmodel, jgd, tx, PARTIAL)
    jlosses, rho = [], None
    for r in rngs:
        _, g = value_and_grad(state.params, r)
        # the gradient Adam sees: the loss's plus wd·θ
        g = jax.tree_util.tree_map(
            lambda a, th: np.abs(np.asarray(a, np.float64)
                                 + WD * np.asarray(th, np.float64)),
            g["params"], state.params["params"])
        scale = max(a.max() for a in jax.tree_util.tree_leaves(g))
        step_rho = jax.tree_util.tree_map(
            lambda a: (1e-4 * a.max() + 1e-3 * a + 1e-5 * scale)
            / np.maximum(a, 1e-30), g)
        rho = step_rho if rho is None else jax.tree_util.tree_map(
            np.maximum, rho, step_rho)
        state, loss = step(state, jnp.asarray(images), r)
        jlosses.append(float(loss))

    model = _port(fparams)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    gd = GaussianDiffusion(timesteps=1000, beta_schedule="cosine",
                           device="cpu")
    opt = trainer.make_optimizer(model.parameters(), LR, WD)
    tstep = trainer.make_train_step(model, gd, opt, PARTIAL, None)
    losses = []
    for r in rngs:
        t, noise = _draws(r, 2, images.shape)
        losses.append(float(tstep(images, t=t, noise=noise)))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = state_dict_from_flax(model, {"params": jax.tree_util.tree_map(
        np.asarray, state.params["params"])})
    rho = {k: v.numpy() for k, v in state_dict_from_flax(
        model, {"params": jax.tree_util.tree_map(
            lambda a: np.minimum(a, 1.0).astype(np.float32), rho)}).items()}
    assert int(opt.state_dict()["state"][0]["step"]) == 3
    for name, p in model.named_parameters():
        moved = (p.detach() - start[name]).numpy().astype(np.float64)
        jmoved = (want[name] - start[name]).numpy().astype(np.float64)
        tol = (1e-3 * LR + 1e-3 * np.abs(jmoved)
               + 3 * LR * np.minimum(1.0, 2 * rho[name]))
        assert np.all(np.abs(moved - jmoved) <= tol), (
            name, float(np.abs(moved - jmoved).max()))


def test_train_step_draws_from_its_generator_and_clamps():
    """Without t and noise the step draws t ~ U[0, partial) and ε from
    its generator (t first): the same seed gives the same step; inputs
    are clamped to ≥ 0 first."""
    torch.manual_seed(0)
    cfg = dict(IMG_LIKE, model_channels=8, num_heads=1)
    base = UNetModel(**cfg, device="cpu")
    gd = GaussianDiffusion(timesteps=100, beta_schedule="cosine",
                           device="cpu")
    images = np.random.default_rng(1).normal(0, 1, (3, 8, 8, 1)).astype(
        np.float32)
    runs = []
    for images_in in (images, np.maximum(images, 0.0), images):
        model = UNetModel(**cfg, device="cpu")
        model.load_state_dict(base.state_dict())
        opt = trainer.make_optimizer(model.parameters(), 1e-3)
        gen = torch.Generator().manual_seed(5)
        step = trainer.make_train_step(model, gd, opt, 10, gen)
        runs.append((float(step(images_in)), model.state_dict()))
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, 10, (3,), generator=g)
    noise = torch.randn((3, 1, 8, 8), generator=g)
    model = UNetModel(**cfg, device="cpu")
    model.load_state_dict(base.state_dict())
    x = torch.from_numpy(np.maximum(images, 0.0)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = float(gd.train_loss(model, x, t, noise))
    assert runs[0][0] == runs[1][0] == runs[2][0] == want
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[2][1][k])


def test_flatten_patches_matches_jax():
    rng = np.random.default_rng(0)
    patched = rng.random((2, 3, 4, 5, 1)).astype(np.float32)
    plain = rng.random((2, 4, 5, 1)).astype(np.float32)
    for batch in (patched, plain):
        np.testing.assert_array_equal(trainer.flatten_patches(batch),
                                      jtrainer.flatten_patches(batch))
    assert trainer.flatten_patches(patched).shape == (6, 4, 5, 1)


@pytest.mark.parametrize("cfg", [
    IMG_LIKE,
    dict(in_channels=1, model_channels=8, out_channels=1, num_res_blocks=1,
         attention_resolutions=(2,), channel_mult=(0.25, 0.5, 8),
         num_heads=2)], ids=["img-like", "proj-like-planar"])
def test_remat_gives_the_same_gradients(case, cfg):
    """torch.utils.checkpoint around each residual and attention block
    recomputes the same forward in the backward: every gradient is equal
    with remat on and off (the proj-like model runs planar_unit's
    Function under the checkpoint)."""
    torch.manual_seed(2)
    grads = []
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (2, 1, 13, 11)).astype(np.float32))
    t = torch.tensor([3, 30])
    base = UNetModel(**cfg, device="cpu").state_dict()
    for remat in (False, True):
        model = UNetModel(**cfg, device="cpu", remat=remat)
        model.load_state_dict(base)
        (model(x, t) ** 2).mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0)


def test_tiny_model_loss_falls():
    """The verify skill's flow 3: the tiny model's training loss falls
    over 30 steps on a fixed batch (mean of the last 5 steps under 0.7
    of the first 5)."""
    torch.manual_seed(0)
    model = UNetModel(in_channels=1, model_channels=8, out_channels=1,
                      num_res_blocks=1, attention_resolutions=(4,),
                      channel_mult=(1, 1, 2), num_heads=1, device="cpu",
                      remat=True)
    gd = GaussianDiffusion(timesteps=50, beta_schedule="cosine",
                           device="cpu")
    opt = trainer.make_optimizer(model.parameters(), 3e-3)
    step = trainer.make_train_step(model, gd, opt, 10,
                                   torch.Generator().manual_seed(0))
    yy, xx = np.mgrid[:16, :16]
    images = np.stack([np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / 20.0)
                       for c in (5, 8, 11, 7)])[..., None].astype(np.float32)
    losses = [float(step(images)) for _ in range(30)]
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses

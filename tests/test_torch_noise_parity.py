"""The port's samplers against the JAX package with the same NON-ZERO
noise on both sides. The zero-noise parity tests (test_torch_guided.py,
test_torch_sparse.py, test_torch_pipeline.py) cannot see the noise terms:
the partial re-noise √(1−ᾱ)·ε, the posterior term exp(½·log σ²)·z and the
DDIM draws. Here ``jax.random.normal`` and the port's
``diffusion.noise_like`` are both replaced by :func:`shape_noise`, one
seeded array per shape, so both packages add the same numbers.

Every case runs the port a second time with the noise negated and shows
that the same comparison then fails by at least 10× its tolerance: the
noise reaches the output, and the tolerance is tight enough to see it.

What this cannot see: every draw of one shape in a run is the same
array (JAX's draws inside a jitted scan are traced once, so a draw
cannot depend on the step), so a port that reused one draw for ε and z,
or took a step's draw at another step, would still match. The file
holds each noise term's scale, sign and place in its step, not the order
or independence of the draws. In the ART case the OS-SART between JAX's
two stages is the port's (see that test's docstring);
tests/test_torch_pipeline.py::test_art_mode_slice_matches_jax holds the
same composition with JAX's convert, at zero noise.

The cases share the pipelines' models and shapes, so JAX compiles each
sampler program once for the file: the img guided case is the pipelines'
image stage, the proj guided case the ART pipeline's proj stage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.diffusion.diffusion import GaussianDiffusion as JaxDiffusion
from ipdm_tpu.diffusion.guided import \
    guided_reverse_process as jax_guided
from ipdm_tpu.diffusion.guided import \
    sparse_guided_reverse_process as jax_sparse
from ipdm_tpu.ops.lambda_curve import proj_curve_init as jax_proj_curve
from ipdm_tpu.ops.sharpen import tensor_sharpen as jax_sharpen
from ipdm_tpu.recon.fbp import FBPGeometry as JaxGeometry
from ipdm_tpu.recon.fbp_fast import fbp_convert_fast as jax_fbp
from ipdm_tpu_torch.diffusion import diffusion as port_diffusion
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.diffusion.guided import (guided_reverse_process,
                                             sparse_guided_reverse_process)
from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
from ipdm_tpu_torch.ops.lambda_curve import proj_curve_init
from ipdm_tpu_torch.recon.convertor import Convertor
from ipdm_tpu_torch.recon.fbp import FBPGeometry
from tests.test_torch_guided import TINY, tiny_pair
from tests.test_torch_pipeline import (ART_OPT, GEOM, IMG_TINY, OPT,
                                       PROJ_TINY, T_START)

NOISE_SEED = 20261018
CONTROL = 10.0   # the negated-noise run must miss by this many tolerances


def shape_noise(shape) -> np.ndarray:
    """A seeded standard normal over (B, H, W), reshaped to ``shape``: the
    same array for every draw of one shape. C = 1 in both UNets' layouts
    (NHWC [B, H, W, 1] in JAX, NCHW [B, 1, H, W] in the port), so both
    read the same values in the same order. It is a constant, so it holds
    inside JAX's jitted ``lax.scan`` too."""
    b, d1, d2, d3 = (int(d) for d in shape)
    if 1 not in (d1, d3):
        raise ValueError(f"noise of shape {shape}: expected one channel")
    h, w = (d1, d2) if d3 == 1 else (d2, d3)
    return np.random.default_rng(NOISE_SEED).standard_normal(
        (b, h, w), dtype=np.float32).reshape(b, d1, d2, d3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the port's side is thousands of small PyTorch
    ops, which thrash when every test worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def same_noise(monkeypatch):
    """Both packages draw :func:`shape_noise`; returns ``sign(s)``, which
    sets the port's draws to s·noise (−1: the negated control)."""
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape=(), dtype=jnp.float32:
        jnp.asarray(shape_noise(shape), dtype))

    def sign(s):
        monkeypatch.setattr(
            port_diffusion, "noise_like",
            lambda x, generator: s * torch.from_numpy(
                shape_noise(x.shape)).to(x.dtype))

    sign(1.0)
    return sign


@pytest.fixture(scope="module")
def pairs():
    """The pipelines' proj and img UNets, Flax and port, shared by the
    cases (their weights drawn with numpy before any noise patch)."""
    return tiny_pair(PROJ_TINY, seed=1), tiny_pair(IMG_TINY, seed=2)


@pytest.fixture(scope="module")
def sparse_pair():
    """test_torch_sparse.py's tiny UNet, shared by the two DDIM cases."""
    return tiny_pair(TINY, seed=7)


def excess(got, want, rtol, atol) -> float:
    """max |got − want| / (atol + rtol·|want|): ≤ 1 inside the tolerance
    (numpy's assert_allclose rule)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc_all(xs):
    return [x.permute(0, 2, 3, 1).numpy() for x in xs]


def check(label, run_port, want, sign, rtol, atol):
    """run_port() (a list of NHWC arrays) against ``want`` with the same
    noise, then with the port's noise negated. Prints both readings."""
    got = run_port()
    assert len(got) == len(want)
    inside = max(excess(g, w, rtol, atol) for g, w in zip(got, want))
    sign(-1.0)
    negated = max(excess(g, w, rtol, atol) for g, w in zip(run_port(), want))
    sign(1.0)
    print(f"{label}: same noise {inside:.4f} of the tolerance (rtol {rtol}, "
          f"atol {atol}); negated noise {negated:.1f}×")
    assert inside <= 1.0, f"{label}: {inside}× the tolerance"
    assert negated >= CONTROL, (
        f"{label}: negated noise only {negated}× the tolerance")


JD = JaxDiffusion(1000, "cosine")
KEY = jax.random.PRNGKey(0)
LD_PROJ = (np.random.default_rng(3).random((1, 90, 64, 1))
           .astype(np.float32) * 4.0)
PROJ_PER_PIXEL = dict(t_start=T_START, clip=False, eta=0.5, mode="proj",
                      constant_guidance=None, lambda_ratio=1,
                      kernel_size=4, amplitude=7)
IMG_STAGE = dict(t_start=T_START, clip=True, eta=0.7, mode="img",
                 constant_guidance=0.45)


def port_gd():
    return GaussianDiffusion(1000, "cosine", device="cpu")


# --- guided_reverse_process ------------------------------------------------
# the zero-noise guided tests' tolerance: f32 sums in another order


def test_guided_img_constant_lambda(same_noise, pairs):
    """img mode at constant λ (the pipelines' image stage, with its ldct
    term): three iterations and the ensemble."""
    _, (jimg, img) = pairs
    x = np.random.default_rng(11).random((1, 32, 32, 1)).astype(
        np.float32) * 0.8
    want, _, _ = jax_guided(jimg, JD, jnp.asarray(x), KEY,
                            ldct=jnp.asarray(x), **IMG_STAGE)
    check("guided img, constant λ",
          lambda: nhwc_all(guided_reverse_process(
              img, port_gd(), nchw(x), None, ldct=nchw(x),
              **IMG_STAGE)[0]),
          [np.asarray(w) for w in want], same_noise, 1e-4, 1e-4)


def test_guided_proj_per_pixel_lambda(same_noise, pairs):
    """proj mode, the per-pixel λ after the cosine-λ probe (the ART
    pipeline's proj stage): probe, two map-λ iterations, the ensemble."""
    (jproj, proj), _ = pairs
    want, _, _ = jax_guided(jproj, JD, jnp.asarray(LD_PROJ), KEY,
                            lambda_curve=jax_proj_curve(), **PROJ_PER_PIXEL)
    assert len(want) == 4
    check("guided proj, per-pixel λ",
          lambda: nhwc_all(guided_reverse_process(
              proj, port_gd(), nchw(LD_PROJ), None,
              lambda_curve=proj_curve_init(), **PROJ_PER_PIXEL)[0]),
          [np.asarray(w) for w in want], same_noise, 1e-4, 1e-4)


# --- sparse_guided_reverse_process (DDIM) ----------------------------------
# test_torch_sparse.py's img settings at T = 50 from t = 9, where the
# posterior variance that scales z (σ = η·posterior_variance, the
# reference's override) is large enough to show; one (t, steps) for the
# three passes, so JAX compiles one DDIM program

SPARSE = dict(t_start=[9, 9, 9], ddim_timesteps=[2, 2, 2],
              condition_lambda_max=0.5, condition_lambda_min=0.3, eta=0.7,
              clip_denoised=True)


@pytest.mark.parametrize("ddim_eta", [0.0, 0.8])
def test_sparse_ddim(same_noise, sparse_pair, ddim_eta):
    jfn, model = sparse_pair
    x = np.random.default_rng(3).random((1, 16, 16, 1)).astype(
        np.float32) * 0.8
    want = jax_sparse(jfn, JaxDiffusion(50, "cosine"), jnp.asarray(x), KEY,
                      ddim_eta=ddim_eta, **SPARSE)
    want = [np.asarray(w) for w in want]
    gd = GaussianDiffusion(50, "cosine", device="cpu")

    def run():
        return nhwc_all(sparse_guided_reverse_process(
            model, gd, nchw(x), None, ddim_eta=ddim_eta, **SPARSE))

    check(f"sparse, ddim_eta {ddim_eta}", run, want, same_noise, 1e-4,
          1e-4)
    if ddim_eta:
        # z alone: the q_sample draw kept, every DDIM draw negated
        draws = []

        def z_negated(x, generator):
            draws.append(x.shape)
            s = 1.0 if len(draws) == 1 else -1.0
            return s * torch.from_numpy(shape_noise(x.shape)).to(x.dtype)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_diffusion, "noise_like", z_negated)
            got = run()
        assert len(draws) == 1 + sum(SPARSE["ddim_timesteps"])
        z_only = max(excess(g, w, 1e-4, 1e-4) for g, w in zip(got, want))
        print(f"sparse, ddim_eta {ddim_eta}: the DDIM z alone negated "
              f"{z_only:.1f}×")
        assert z_only >= CONTROL


# --- progressive_denoiser --------------------------------------------------
# the zero-noise pipeline tests' tolerance (rtol 1e-3, atol 1e-4): the
# convert's f32 sums in another order between two UNet stages


def test_progressive_fbp_mode(same_noise, pairs):
    """proj guided at constant λ → batched FBP of the kept iterations →
    the last → sharpen 70 → img guided (bench.py:204-241)."""
    (jproj, proj), (jimg, img) = pairs
    iters, _, _ = jax_guided(jproj, JD, jnp.asarray(LD_PROJ), KEY,
                             t_start=T_START, clip=False, eta=0.4,
                             mode="proj", constant_guidance=0.5)
    stacked = jnp.concatenate([p[..., 0] for p in iters], axis=0)
    x = jax_sharpen(jax_fbp(stacked, JaxGeometry(**GEOM))[-1:][..., None],
                    70)
    out, _, _ = jax_guided(jimg, JD, x, KEY, ldct=x, **IMG_STAGE)
    conv = Convertor("FBP", FBPGeometry(**GEOM))
    check("progressive, FBP mode",
          lambda: [progressive_denoiser(OPT, proj, img, LD_PROJ, None,
                                        convertor=conv, sharpen_num=70,
                                        device="cpu").numpy()],
          [np.asarray(out[-1])], same_noise, 1e-3, 1e-4)


def test_progressive_art_mode_with_ultra(same_noise, pairs):
    """proj guided with the per-pixel λ → batched OS-SART → the last →
    img guided → the ultra pass (3×5 steps at λ 0.6, η 0.6). The convert
    between JAX's stages is the port's, on JAX's proj iterations: it draws
    no noise, tests/test_torch_sart_fast.py holds it to JAX's, and
    tests/test_torch_pipeline.py holds this composition with JAX's convert
    at zero noise; JAX's first OS-SART at this geometry costs ~17 s of
    one-off compiles, which would put this file over its minute."""
    (jproj, proj), (jimg, img) = pairs
    iters, _, _ = jax_guided(jproj, JD, jnp.asarray(LD_PROJ), KEY,
                             lambda_curve=jax_proj_curve(),
                             **PROJ_PER_PIXEL)
    conv = Convertor("ART", FBPGeometry(**GEOM), nstart=2, nsubsets=6)
    stacked = np.concatenate([np.asarray(p)[..., 0] for p in iters], axis=0)
    x = jnp.asarray(conv(torch.from_numpy(stacked))[-1:, :, :, None].numpy())
    out, _, _ = jax_guided(jimg, JD, x, KEY, ldct=x, **IMG_STAGE)
    out, _, _ = jax_guided(jimg, JD, out[-1], KEY, t_start=[5, 5, 5],
                           clip=True, eta=0.6, mode="img",
                           constant_guidance=0.6, ldct=x)
    check("progressive, ART mode + ultra",
          lambda: [progressive_denoiser(ART_OPT, proj, img, LD_PROJ, None,
                                        convertor=conv,
                                        device="cpu").numpy()],
          [np.asarray(out[-1])], same_noise, 1e-3, 1e-4)

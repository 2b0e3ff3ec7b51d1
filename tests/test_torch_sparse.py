"""The port's sparse (DDIM) sampling against the JAX package: the three
GaussianDiffusion helpers (q_mean_variance, p_mean_variance,
lambda_t_calculate), ``ddim_sample`` and ``sparse_guided_reverse_process``
with the tiny UNet pair of tests/test_torch_guided.py and the noise
forced to zero on both sides, in img and proj settings; and the engine's
sparse routing (λ ranges, clip, three results, then the ultra pass and a
batched convert of three iterations) against the JAX engine's, with the
samplers replaced by recorders on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.config.config import IPDMConfig as JaxConfig
from ipdm_tpu.diffusion.diffusion import GaussianDiffusion as JaxDiffusion
from ipdm_tpu.diffusion.guided import _split_model_fn
from ipdm_tpu.diffusion.guided import ddim_sample as jax_ddim
from ipdm_tpu.diffusion.guided import \
    sparse_guided_reverse_process as jax_sparse
from ipdm_tpu.engine import denoiser as jax_engine_mod
from ipdm_tpu_torch.config.config import IPDMConfig
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.diffusion.guided import (ddim_sample,
                                             sparse_guided_reverse_process)
from ipdm_tpu_torch.engine import denoiser as port_engine_mod
from tests.test_torch_engine import ARCH, GEO, corpus  # noqa: F401
from tests.test_torch_guided import TINY, tiny_pair, zero_noise  # noqa: F401

T = 50  # timesteps of the tiny diffusions


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _miss(got, want, tol=1e-4):
    """The planted control: got lies outside the tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    assert (np.abs(got - want) > tol + tol * np.abs(want)).any()


def test_diffusion_helpers_match_jax():
    jd, pd = JaxDiffusion(T, "cosine"), GaussianDiffusion(T, "cosine",
                                                          device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
    t = np.array([3, 41], np.int32)
    for got, want in zip(pd.q_mean_variance(torch.from_numpy(x),
                                            torch.from_numpy(t).long()),
                         jd.q_mean_variance(jnp.asarray(x), jnp.asarray(t))):
        _close(got, want, 1e-6)
    w = rng.standard_normal((1, 8, 8)).astype(np.float32) * 0.3
    jfn = lambda xx, tt: jnp.tanh(xx * jnp.asarray(w)[None])
    pfn = lambda xx, tt: torch.tanh(xx * torch.from_numpy(w)[None])
    for clip in (False, True):
        got = pd.p_mean_variance(pfn, torch.from_numpy(x),
                                 torch.from_numpy(t).long(), clip)
        want = jd.p_mean_variance(jfn, jnp.asarray(x), jnp.asarray(t), clip)
        for g, wv in zip(got, want):
            _close(g, wv, 1e-5)
    for eta in (0.9, 0.3):
        _close(pd.lambda_t_calculate(eta), jd.lambda_t_calculate(eta), 1e-5)
    _miss(pd.lambda_t_calculate(0.89), jd.lambda_t_calculate(0.9), 1e-5)


SETTINGS = {"img": dict(scale=0.8, clip=True, lam=(0.5, 0.3), eta=0.7),
            "proj": dict(scale=3.0, clip=False, lam=(0.49, 0.35), eta=0.5)}


def _inputs(mode, seed):
    x = np.random.default_rng(seed).random((1, 16, 16, 1)).astype(np.float32)
    return x * SETTINGS[mode]["scale"]


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("mode,steps,ddim_eta", [("img", 2, 0.0),
                                                 ("proj", 1, 0.5)])
def test_ddim_sample_matches_jax(zero_noise, mode, steps, ddim_eta):
    jfn, model = tiny_pair(TINY, seed=6)
    s = SETTINGS[mode]
    x = _inputs(mode, 1)
    cond = _inputs(mode, 2)
    kw = dict(ddim_timesteps=steps, ddim_eta=ddim_eta,
              clip_denoised=s["clip"])
    apply_fn, params = _split_model_fn(jfn)
    want = jax_ddim(apply_fn, JaxDiffusion(T, "cosine"), params,
                    jnp.asarray(x), jnp.asarray(cond), 9, 0.45,
                    jax.random.PRNGKey(0), **kw)
    gd = GaussianDiffusion(T, "cosine", device="cpu")
    with torch.no_grad():
        got = ddim_sample(model, gd, _nchw(x), _nchw(cond), 9, 0.45, None,
                          **kw)
        planted = ddim_sample(model, gd, _nchw(x), _nchw(cond), 9, 0.55,
                              None, **kw)
    _close(got.permute(0, 2, 3, 1), want)
    _miss(planted.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("mode", ["img", "proj"])
def test_sparse_guided_reverse_process_matches_jax(zero_noise, mode):
    """Three DDIM passes (1, 2, 2 steps from t = 3, 4, 3), λ on the
    engine's ramp, the condition blended by η after each; the planted
    control runs the ramp upside down."""
    jfn, model = tiny_pair(TINY, seed=7)
    s = SETTINGS[mode]
    x = _inputs(mode, 3)
    lam_max, lam_min = s["lam"]
    kw = dict(t_start=[3, 4, 3], ddim_timesteps=[1, 2, 2], eta=s["eta"],
              clip_denoised=s["clip"])
    want = jax_sparse(jfn, JaxDiffusion(T, "cosine"), jnp.asarray(x),
                      jax.random.PRNGKey(0), condition_lambda_max=lam_max,
                      condition_lambda_min=lam_min, **kw)
    gd = GaussianDiffusion(T, "cosine", device="cpu")
    got = sparse_guided_reverse_process(
        model, gd, _nchw(x), None, condition_lambda_max=lam_max,
        condition_lambda_min=lam_min, **kw)
    planted = sparse_guided_reverse_process(
        model, gd, _nchw(x), None, condition_lambda_max=lam_min,
        condition_lambda_min=lam_max, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w)
    _miss(planted[-1].permute(0, 2, 3, 1), want[-1])


# --- the engine's routing ---------------------------------------------------

SPARSE = dict(geometry=GEO, test_numbers=0, metrics=["psnr"],
              sample_method_proj="sparse", sample_method_img="sparse",
              t_start_proj=[4, 3, 3], t_start_img=[3, 3, 2],
              ddim_timesteps_proj=[1, 2, 2], ddim_timesteps_img=[2, 1, 1],
              eta_proj=0.45, eta_img=0.65, convertor="FBP",
              ultra_img_denoise=True, mode="test_prog",
              save_it_state_proj=True, save_it_state_img=True, **ARCH)


def _recorders(monkeypatch, module, jax_side):
    """Replace the engine module's two samplers by recorders: the sparse
    one returns x·0.9, x·0.8, x·0.7; the dense one (the ultra pass) four
    iterations x·0.6 .. x·0.3, in the tuple form of its side."""
    calls = []

    def sparse(model_fn, gd, x, rng, **kw):
        calls.append(("sparse", kw))
        return [x * f for f in (0.9, 0.8, 0.7)]

    def dense(model_fn, gd, x, rng, **kw):
        calls.append(("dense", kw))
        iters = [x * f for f in (0.6, 0.5, 0.4, 0.3)]
        return (iters, None, None) if jax_side else (iters, None)

    monkeypatch.setattr(module, "sparse_guided_reverse_process", sparse)
    monkeypatch.setattr(module, "guided_reverse_process", dense)
    return calls


def test_engine_routes_sparse_sampling_like_jax(corpus, tmp_path,
                                                monkeypatch):
    cfg = dict(SPARSE, **corpus)
    jeng = jax_engine_mod.ProgressiveDomainDenoiser(
        JaxConfig(device="cpu", **cfg), result_save_path=str(tmp_path / "j"))
    eng = port_engine_mod.ProgressiveDomainDenoiser(
        IPDMConfig(device="cpu", **cfg), result_save_path=str(tmp_path / "p"))
    jcalls = _recorders(monkeypatch, jax_engine_mod, True)
    calls = _recorders(monkeypatch, port_engine_mod, False)
    sample = jeng.test_dataset[0]
    for e in (jeng, eng):
        e.temp_clear()
        e.data_sample_load(ldct=sample[0][None], ldproj=sample[3][None],
                           fdproj=sample[1], fdct=sample[2][None])
        e.progressive_denoiser()
    assert [c[0] for c in calls] == ["sparse", "sparse", "dense"]
    keys = ("t_start", "condition_lambda_max", "condition_lambda_min",
            "ddim_timesteps", "eta", "clip_denoised")
    for (kind, kw), (jkind, jkw) in zip(calls, jcalls):
        assert kind == jkind
        want = {k: jkw[k] for k in keys if k in jkw}
        assert {k: kw[k] for k in keys if k in kw} == want
    (_, proj_kw), (_, img_kw), (_, ultra_kw) = calls
    assert (proj_kw["condition_lambda_max"], proj_kw["condition_lambda_min"],
            proj_kw["clip_denoised"]) == (0.49, 0.35, False)
    assert (img_kw["condition_lambda_max"], img_kw["condition_lambda_min"],
            img_kw["clip_denoised"]) == (0.5, 0.3, True)
    assert ultra_kw["t_start"] == [5, 5, 5] and ultra_kw["eta"] == 0.6
    assert eng.noise_strength is None and jeng.noise_strength is None
    # three converted iterations in one batched convert, then 3 + 4 image
    # iterations (the sparse results and the ultra pass's)
    assert len(eng.proj_denoise_convert2img_result) == 3
    assert len(eng.progressive_denoise_result) == 7
    for store in ("proj_denoise_convert2img_result",
                  "progressive_denoise_result"):
        got, want = getattr(eng, store), getattr(jeng, store)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-4 * np.abs(want[k]).max())

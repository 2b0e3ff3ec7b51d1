"""The port's frozen end-to-end golden fixture: the twin of
tests/test_golden.py for ``ipdm_tpu_torch``.

jax.random and torch draw different noise and different initial weights,
so the JAX package's pins (tests/golden_fixture.json) cannot hold the
port's samplers. This file pins the port's own aggregate PSNR / SSIM in
tests/torch_golden_fixture.json, on the same deterministic 4-slice corpus
on the same GEO_TINY scanner (built with the port's ``shepp_logan`` and
exact ``forward_project``), through the port's engine with the same
options on the CPU:

  * untrained (tier-1) — seeded torch weights, ART convert + ultra pass,
    2 slices; pins the sampler / convertor composition;
  * trained (``slow``) — 4 epochs of each domain, checkpoint reload,
    then the progressive test; pins the train → test pipeline.

The LDCT group scores the corpus's low-dose images, which the numpy
generator draws alike for both packages, so it must also equal JAX's LDCT
pins (test_golden_ldct_matches_jax_pins).

Regenerate the pins ONLY on an intentional numeric change:
    IPDM_TORCH_GOLDEN_REGEN=1 python -m pytest tests/test_torch_golden.py \\
        -q -m ""
then commit the updated tests/torch_golden_fixture.json.

Tolerances are JAX's: 0.05 dB PSNR / 1e-3 SSIM.
"""

import json
import os

import numpy as np
import pytest
import torch

from ipdm_tpu_torch.config.config import IPDMConfig
from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
from tests.test_golden import GEO_TINY, _check, _grab

HERE = os.path.dirname(__file__)
FIXTURE = os.path.join(HERE, "torch_golden_fixture.json")
JAX_FIXTURE = os.path.join(HERE, "golden_fixture.json")
REGEN = bool(os.environ.get("IPDM_TORCH_GOLDEN_REGEN"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the port's side is thousands of small PyTorch
    ops, which thrash when every test worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """test_golden.py's deterministic 4-slice 4-stream corpus, made with
    the port's phantom and exact projector."""
    from ipdm_tpu_torch.recon.geometry import (FanBeamGeometry, area_lut,
                                               default_betas)
    from ipdm_tpu_torch.recon.phantom import shepp_logan
    from ipdm_tpu_torch.recon.projector import forward_project

    root = str(tmp_path_factory.mktemp("torch_golden_data"))
    g = FanBeamGeometry(**GEO_TINY)
    lut = torch.as_tensor(area_lut(g))
    betas = torch.as_tensor(default_betas(g))
    rng = np.random.default_rng(1234)
    for i in range(4):
        ph = np.asarray(shepp_logan(32), np.float32) * 0.36 * (1 + 0.07 * i)
        proj = forward_project(torch.as_tensor(ph), g, lut, betas).numpy()
        ld_proj = proj + rng.normal(0, 0.02 * proj.max(),
                                    proj.shape).astype(np.float32)
        ld_img = (ph.T + rng.normal(0, 0.03, ph.shape)).astype(np.float32)
        for kind, arr in (("fd_img", ph.T), ("ld_img", ld_img),
                          ("fd_proj", proj), ("ld_proj", ld_proj)):
            d = os.path.join(root, kind, "L001")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{i:03d}.npy"), arr)
    return root


def _opt(root, mode, **kw):
    """test_golden.py's ``_opt`` for the port, on the CPU."""
    opt = IPDMConfig(
        mode=mode, run_name="g", device="cpu", batch_size=1,
        test_batch_size=1, max_epochs=2, save_freq=2, test_numbers=2,
        init_lr=1e-3, seed=9527, convertor="ART", ultra_img_denoise=True,
        model_channels_img=8, channel_mult_img=[1, 1, 2],
        attention_resolutions_img=[4], timesteps_img=50,
        partial_timesteps_img=10, t_start_img=[3, 2],
        constant_guidance_img=0.45,
        model_channels_proj=8, channel_mult_proj=[1, 1, 2],
        attention_resolutions_proj=[4], timesteps_proj=50,
        partial_timesteps_proj=10, t_start_proj=[3, 2],
        constant_guidance_proj=0.5, sart_nstart=2, sart_subsets=6,
        metrics=["psnr", "ssim"], geometry=GEO_TINY,
        patch=[16, 16], patch_per_image=2,
        **{f"{m}_dataset_path_{k}": os.path.join(root, s)
           for m in ("train", "test")
           for k, s in (("LD_img", "ld_img"), ("FD_img", "fd_img"),
                        ("LD_proj", "ld_proj"), ("FD_proj", "fd_proj"))})
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def _aggregate_metrics(eng):
    with open(os.path.join(eng.save_root_path, "Save_Iter_0",
                           "metric.json")) as f:
        return json.load(f)


def _pin(name: str):
    if not os.path.exists(FIXTURE):
        pytest.fail("tests/torch_golden_fixture.json missing — regenerate "
                    "with IPDM_TORCH_GOLDEN_REGEN=1 (see module docstring)")
    with open(FIXTURE) as f:
        data = json.load(f)
    if name not in data:
        pytest.fail(
            f"golden fixture has no '{name}' pin (keys: {sorted(data)}) — "
            "generate it with IPDM_TORCH_GOLDEN_REGEN=1 python -m pytest "
            "tests/test_torch_golden.py -q -m '' and commit the fixture")
    return data[name]


def _regen_write(name: str, payload: dict):
    data = {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            data = json.load(f)
    data[name] = payload
    with open(FIXTURE, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)


def _check_groups(got: dict, name: str):
    if REGEN:
        _regen_write(name, got)
        return
    want = _pin(name)
    for gname in ("LDCT", "deProj", "deProg"):
        _check(got[gname], want[gname], gname)


@pytest.fixture(scope="module")
def untrained(corpus, tmp_path_factory):
    """The untrained run's aggregate groups: seed-pinned weights through
    the flagship composition (per-iteration proj stage → batched OS-SART
    → img stage → ultra pass) on 2 slices."""
    out = tmp_path_factory.mktemp("torch_golden_untrained")
    eng = ProgressiveDomainDenoiser(_opt(corpus, "test_prog"),
                                    result_save_path=str(out))
    eng.fit()
    return _grab(_aggregate_metrics(eng))


def test_golden_progressive_untrained(untrained):
    """Pins catch any numeric drift in the port's sampler, physics,
    metrics or generator plumbing."""
    _check_groups(untrained, "untrained_prog")


def test_golden_ldct_matches_jax_pins(untrained):
    """The LDCT group scores the same low-dose images as JAX's golden run
    (the corpus's numpy draws), through the port's data path and metrics:
    it equals JAX's LDCT pins at JAX's tolerances."""
    with open(JAX_FIXTURE) as f:
        jax_pins = json.load(f)
    for tier in ("untrained_prog", "trained_prog"):
        _check(untrained["LDCT"], jax_pins[tier]["LDCT"], f"{tier}.LDCT")


@pytest.mark.slow
def test_golden_progressive_trained(corpus, tmp_path):
    """Train both DDPMs for 4 epochs (seeded), reload from checkpoints,
    run the progressive test: a loss-landscape or optimizer regression
    moves these pins."""
    engines = {}
    for domain in ("proj", "img"):
        opt = _opt(corpus, f"train_{domain}", test_numbers=0, max_epochs=4,
                   save_freq=4)
        engines[domain] = ProgressiveDomainDenoiser(
            opt, result_save_path=str(tmp_path / domain))
        engines[domain].fit()
    opt = _opt(corpus, "test_prog",
               load_proj_model_path=engines["proj"].logger.models_save_dir,
               resume_epochs_proj=1,
               load_img_model_path=engines["img"].logger.models_save_dir,
               resume_epochs_img=1)
    eng = ProgressiveDomainDenoiser(opt, result_save_path=str(tmp_path / "o"))
    eng.fit()
    _check_groups(_grab(_aggregate_metrics(eng)), "trained_prog")

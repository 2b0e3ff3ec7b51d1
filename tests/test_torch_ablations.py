"""The port's ablation studies (examples/ablations_torch.py) against the
JAX package's (examples/ablations.py) on the same files and weights.

A corpus of two 32² slices (30 views of 64 detectors) built by the port's
projector and low-dose simulation; one JAX engine and one port engine,
each built by its module's ``_test_engine`` from checkpoints of the same
weights (tiny UNets, every parameter drawn N(0, 0.1) by numpy, carried to
the port through ``state_dict_from_flax``); zero sampler noise on both
sides. The five engine studies run on each engine in ``main``'s order
(nfe, guidance, recon, hu-drift, noise-hist), so the options and the
convertor each study leaves behind (``reset_opt`` keeps the convertor
that ``study_recon`` built last) carry into the next as they do in
``main``; every JSON entry is compared. Then the twin's ``main`` runs the
dose study alone at 16² (port only: it trains four model pairs)."""

import json
import math
import os.path as osp
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.ablations as jabl
import examples.ablations_torch as tabl
from ipdm_tpu.config.config import IPDMConfig as JaxConfig
from ipdm_tpu.engine.checkpoint import CheckpointManager as JaxCheckpoints
from ipdm_tpu.models.unet import build_unet as jax_build_unet
from ipdm_tpu_torch.config.config import IPDMConfig
from ipdm_tpu_torch.diffusion import diffusion as port_diffusion
from ipdm_tpu_torch.engine.checkpoint import CheckpointManager
from ipdm_tpu_torch.models.unet import build_unet
from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
from ipdm_tpu_torch.recon.geometry import FanBeamGeometry
from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom
from ipdm_tpu_torch.recon.sart_fast import project_fast, sart_fast_convert
from ipdm_tpu_torch.recon.simulate import add_noise
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax

# tests/test_torch_engine.py's small scanner at 30 views and its UNets
# (the JAX package compiles each sampler setting of the studies anew on
# the CPU, and its time goes with the sinogram: 30 views rather than 90
# take the file from 180 s to 140 s)
GEO = dict(nx=32, ny=32, dx=42 / 32, dy=42 / 32, nr=64,
           dr=0.0010125 * 912 / 64, na=30, ta_dimx=101, ta_dimy=46)
ARCH = dict(model_channels_img=8, channel_mult_img=[1, 2],
            attention_resolutions_img=[2], model_channels_proj=16,
            channel_mult_proj=[0.5, 1, 1], attention_resolutions_proj=[4])
STUDIES = ("nfe", "guidance", "recon", "hu-drift", "noise-hist")
FUNCS = {"nfe": "study_nfe", "guidance": "study_guidance",
         "recon": "study_recon", "hu-drift": "study_hu_drift",
         "noise-hist": "study_noise_hist"}


def _corpus(root):
    """Two slices in the four-stream layout, from phantoms through the
    port's project_fast, add_noise (dose 0.25) and OS-SART."""
    geom = FanBeamGeometry(**GEO)
    g = fbp_geom_from_fan(geom)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    streams = ("fd_img", "ld_img", "fd_proj", "ld_proj")
    for s in streams:
        (root / s / "P001").mkdir(parents=True)
    for i in range(2):
        vol = torch.from_numpy(random_ellipse_phantom(32, rng)[None].astype(
            np.float32))
        fd_proj = project_fast(vol, g, geom.nr, float(g.nda[0]), float(g.da))
        ld_proj = add_noise(fd_proj, gen, 0.25)
        ld_img = sart_fast_convert(ld_proj, g, nstart=4, nsubsets=18)
        for s, arr in zip(streams, (vol.transpose(1, 2), ld_img, fd_proj,
                                    ld_proj)):
            np.save(root / s / "P001" / f"{i:04d}.npy", arr[0].numpy())
    return {f"{m}_dataset_path_{k}": str(root / s)
            for m in ("train", "test")
            for k, s in (("FD_img", "fd_img"), ("LD_img", "ld_img"),
                         ("FD_proj", "fd_proj"), ("LD_proj", "ld_proj"))}


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """Each study's JSON from the JAX engine and from the port's, the five
    run in main's order on one engine each, at zero sampler noise."""
    root = tmp_path_factory.mktemp("ablations")
    paths = _corpus(root / "data")
    # the options _train_models hands _test_engine, at the small scanner
    common = dict(device="cpu", batch_size=1, save_freq=1, test_numbers=0,
                  init_lr=2e-4, geometry=GEO, metrics=["psnr", "ssim"],
                  patch=None, patch_per_image=None, timesteps_img=1000,
                  partial_timesteps_img=50, timesteps_proj=1000,
                  partial_timesteps_proj=50, max_epochs=1, sart_nstart=2,
                  sart_subsets=6, **ARCH, **paths)
    # checkpoints of the same weights in each package's format (the JAX
    # UNets' parameter shapes by jax.eval_shape: no engine, no compile)
    jckpt = JaxCheckpoints(str(root / "jax_weights"))
    ckpt = CheckpointManager(str(root / "port_weights"))
    jopt, opt = JaxConfig(mode="test_prog", **common), IPDMConfig(**common)
    for seed, domain in ((1, "proj"), (2, "img")):
        shapes = jax.eval_shape(jax_build_unet(jopt, domain).init,
                                jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 1), jnp.float32),
                                jnp.zeros((1,), jnp.int32))
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), shapes)
        jckpt.save(f"{domain}_model", 1, params)
        model = build_unet(opt, domain, device="cpu")
        model.load_state_dict(state_dict_from_flax(model, params))
        ckpt.save(f"{domain}_model", 1, model)
    jdir = jckpt.dir
    jeng = jabl._test_engine(str(root / "jax"), common, jdir, jdir)
    teng = tabl._test_engine(str(root / "port"), common, ckpt.dir, ckpt.dir)
    # zero noise, after the JAX engines drew their initial parameters
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal",
               lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape,
                                                                  dtype))
    mp.setattr(port_diffusion, "noise_like",
               lambda x, generator: torch.zeros_like(x))
    args = SimpleNamespace(test_slices=1)
    res = {"jax": {}, "port": {}}
    try:
        for name in STUDIES:
            res["jax"][name] = getattr(jabl, FUNCS[name])(args, jeng)
            res["port"][name] = getattr(tabl, FUNCS[name])(args, teng)
    finally:
        mp.undo()
    res["convertor"] = {"jax": jeng.convertor, "port": teng.convertor}
    return res


# the engines' images agree to ~1e-4 of their range (tests/test_torch_
# engine.py): a PSNR within 2e-3 dB per dB above 1, a mean HU within
# 1e-3 relative (HU is ~1000× the μ map), the residual std within 1e-3
# relative; a histogram of 32² residuals within 1% of the pixel count in
# L1 (a pixel near a bin edge may cross it)
PSNR_TOL = 2e-3
REL_TOL = 1e-3


def _same(got, want, path):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        if path.endswith("bins"):
            np.testing.assert_array_equal(got, want)
        else:   # a histogram's counts
            l1 = int(np.abs(np.subtract(got, want)).sum())
            assert l1 <= 0.01 * 32 * 32, (path, l1)
            assert sum(got) == sum(want), path
    elif isinstance(want, int):
        assert got == want, path
    else:
        assert math.isfinite(got), path
        if "psnr" in path or path.split("/")[1] in ("guidance", "recon"):
            tol = PSNR_TOL * max(1.0, abs(want))
        else:
            tol = REL_TOL * max(1.0, abs(want))
        assert abs(got - want) <= tol, (path, got, want)


@pytest.mark.parametrize("name", STUDIES)
def test_study_matches_the_jax_package(studies, name):
    """One study's JSON from the twin against examples/ablations.py's, the
    studies run in main's order on one engine each."""
    got, want = studies["port"][name], studies["jax"][name]
    json.dumps(got)   # what main writes
    _same(got, want, f"/{name}")


def test_reset_opt_keeps_the_last_convertor(studies):
    """After study_recon both engines hold the TV convertor it built last
    (reset_opt restores the options, not the convertor): the hu-drift and
    noise-hist studies ran on it, in the JAX package as in the port."""
    for eng in ("jax", "port"):
        assert studies["convertor"][eng].kind == "TV", eng


def test_dose_study_main_port_only(tmp_path):
    """The twin's main with --study dose at 16² and 2 iterations on the
    CPU: the corpus, one base model pair, then per dose a corpus, a model
    pair and a test engine; the JSON's keys are the four doses, each with
    finite LDCT and deProg PSNRs."""
    out = tmp_path / "abl"
    tabl.main(["--out", str(out), "--study", "dose", "--n", "2", "--size",
               "16", "--iters", "2", "--test-slices", "1", "--device",
               "cpu"])
    with open(osp.join(out, "ablation_dose.json")) as f:
        res = json.load(f)
    assert list(res) == ["0.05", "0.1", "0.15", "0.25"]
    for dose, v in res.items():
        assert set(v) == {"ldct_psnr", "deprog_psnr"}, dose
        assert all(math.isfinite(x) for x in v.values()), (dose, v)

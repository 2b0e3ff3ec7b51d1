"""The port's engine (ipdm_tpu_torch/engine/denoiser.py
ProgressiveDomainDenoiser) against the JAX engine on the same files on
disk: a corpus of two 32² slices (90 views of 64 detectors) built by the
port's own projector and low-dose simulation, tiny UNets with the same
weights (the JAX engine's parameters set directly, the port's loaded from
a checkpoint written by its CheckpointManager), zero sampler noise on
both sides. Every stored iteration (the .npz artifacts) and every entry
of every metric.json are compared."""

import json
import os
import os.path as osp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.config.config import IPDMConfig as JaxConfig
from ipdm_tpu.engine.denoiser import ProgressiveDomainDenoiser as JaxEngine
from ipdm_tpu_torch.config.config import IPDMConfig
from ipdm_tpu_torch.diffusion import diffusion as port_diffusion
from ipdm_tpu_torch.engine.checkpoint import CheckpointManager
from ipdm_tpu_torch.engine.denoiser import (ProgressiveDomainDenoiser,
                                            make_convertor, proj_denoiser)
from ipdm_tpu_torch.models.unet import build_unet
from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
from ipdm_tpu_torch.recon.geometry import FanBeamGeometry
from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom
from ipdm_tpu_torch.recon.sart_fast import project_fast, sart_fast_convert
from ipdm_tpu_torch.recon.simulate import add_noise
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax

# a small scanner; the sinogram UNet's middle attention sees 45×32 tokens
GEO = dict(nx=32, ny=32, dx=42 / 32, dy=42 / 32, nr=64,
           dr=0.0010125 * 912 / 64, na=90, ta_dimx=101, ta_dimy=46)
ARCH = dict(model_channels_img=8, channel_mult_img=[1, 2],
            attention_resolutions_img=[2], model_channels_proj=16,
            channel_mult_proj=[0.5, 1, 1], attention_resolutions_proj=[4])
BASE = dict(geometry=GEO, test_numbers=0, test_result_data_save=True,
            metrics=["psnr", "ssim"], sart_nstart=2, sart_subsets=6,
            t_start_proj=[2, 2], t_start_img=[2, 2], eta_proj=0.4,
            eta_img=0.7, constant_guidance_proj=0.5,
            constant_guidance_img=0.45, save_it_state_proj=True,
            save_it_state_img=True, ultra_img_denoise=False, **ARCH)
STORES = ("prog_denoise_result", "proj_denoise_result",
          "img_denoise_result", "proj_denoise_result_2img")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two slices in the four-stream layout, from phantoms through the
    port's project_fast, add_noise (dose 0.25) and OS-SART."""
    root = tmp_path_factory.mktemp("corpus")
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
    return {f"test_dataset_path_{k}": str(root / s)
            for k, s in (("FD_img", "fd_img"), ("LD_img", "ld_img"),
                         ("FD_proj", "fd_proj"), ("LD_proj", "ld_proj"))}


def _zero_noise(monkeypatch):
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(port_diffusion, "noise_like",
                        lambda x, generator: torch.zeros_like(x))


@pytest.fixture(scope="module")
def jax_engine(corpus, tmp_path_factory):
    """One JAX engine for the whole file (its samplers compile once per
    setting), in test_prog mode so it holds both models, with every
    parameter leaf drawn N(0, 0.1) from a numpy seed; and the directory
    of the port's checkpoints of the same weights, written by its
    CheckpointManager."""
    root = tmp_path_factory.mktemp("engines")
    cfg = dict(BASE, **corpus, mode="test_prog", convertor="FBP")
    jeng = JaxEngine(JaxConfig(device="cpu", **cfg),
                     result_save_path=str(root / "jax"))
    ckpt = CheckpointManager(str(root / "weights"))
    opt = IPDMConfig(device="cpu", **cfg)
    for seed, domain in ((1, "proj"), (2, "img")):
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32),
            jax.device_get(getattr(jeng, f"{domain}_params")))
        setattr(jeng, f"{domain}_params", params)
        model = build_unet(opt, domain, device="cpu")
        model.load_state_dict(state_dict_from_flax(model, params))
        ckpt.save(f"{domain}_model", 1, model)
    return jeng, ckpt


def _port_engine(ckpt, tmp_path, corpus, **kw):
    cfg = dict(BASE, **corpus, convertor="FBP", mode="test_prog")
    cfg.update(kw)
    opt = IPDMConfig(device="cpu", resume_epochs_img=1, resume_epochs_proj=1,
                     load_img_model_path=ckpt.dir,
                     load_proj_model_path=ckpt.dir, **cfg)
    return ProgressiveDomainDenoiser(opt,
                                     result_save_path=str(tmp_path / "port"))


def _engines(jax_engine, tmp_path, corpus, monkeypatch, **kw):
    """The JAX engine set to ``kw`` (through its update_opt, from its
    initial options) and a new port engine on the same config, files and
    weights; zero sampler noise on both."""
    jeng, ckpt = jax_engine
    shutil.rmtree(jeng.save_root_path)     # an earlier case's artifacts
    os.makedirs(jeng.save_root_path)
    jeng.reset_opt()
    jeng.update_opt(dict(dict(convertor="FBP", mode="test_prog"), **kw))
    eng = _port_engine(ckpt, tmp_path, corpus, **kw)
    _zero_noise(monkeypatch)
    return jeng, eng, ckpt


def _compare_runs(jeng, eng, stores):
    """Every slice's .npz stores and metric.json, and the aggregate."""
    for sl in ("0000", "0001"):
        jdir = osp.join(jeng.save_root_path, "Save_Iter_0", "P001", sl)
        pdir = osp.join(eng.save_root_path, "Save_Iter_0", "P001", sl)
        for store in STORES:
            jf, pf = (osp.join(d, store + ".npz") for d in (jdir, pdir))
            assert osp.exists(pf) == osp.exists(jf) == (store in stores), \
                store
            if store not in stores:
                continue
            want, got = np.load(jf), np.load(pf)
            assert sorted(got.files) == sorted(want.files) and got.files
            for k in want.files:
                assert got[k].shape == want[k].shape and got[k].ndim == 4
                # two f32 pipelines of UNet evals and a convert: 1e-3
                # relative, 1e-4 of the [0, ~1] value range absolute
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                           atol=1e-4, err_msg=f"{store}/{k}")
        _compare_metrics(osp.join(pdir, "metric.json"),
                         osp.join(jdir, "metric.json"))
    agg = [osp.join(e.save_root_path, "Save_Iter_0", "metric.json")
           for e in (eng, jeng)]
    _compare_metrics(*agg)
    return json.load(open(agg[0]))


def _compare_metrics(port_file, jax_file):
    got, want = json.load(open(port_file)), json.load(open(jax_file))
    assert got.keys() == want.keys()
    n = 0
    for mode in want:
        assert got[mode].keys() == want[mode].keys(), mode
        for k, v in want[mode].items():
            # images that agree to 1e-4 of their range: PSNR (dB) and the
            # [0, 1] indices to 2e-3 of their size; a std of two slices
            # likewise, absolutely
            assert np.isfinite(got[mode][k])
            assert abs(got[mode][k] - v) <= 2e-3 * max(1.0, abs(v)), (
                mode, k, got[mode][k], v)
            n += 1
    assert n > 0


@pytest.mark.parametrize("case", ["fbp", "art", "normal", "benchmark"])
def test_test_prog_matches_jax_engine(jax_engine, tmp_path, corpus,
                                      monkeypatch, case):
    kw = dict(
        fbp=dict(convertor="FBP", fbp_sharpen=True,
                 metrics=["psnr", "ssim", "fsim", "vif", "nqm"]),
        # the Mayo preset's shape: per-pixel proj λ after a probe, OS-SART,
        # the ultra pass
        art=dict(convertor="ART", constant_guidance_proj=None,
                 t_start_proj=[2, 2, 2], eta_proj=0.5, lambda_ratio_proj=1,
                 amplitude_proj=7, ultra_img_denoise=True),
        normal=dict(convertor="FBP", normal=True),
        benchmark=dict(convertor="FBP", benchmark_test=True),
    )[case]
    jeng, eng, _ = _engines(jax_engine, tmp_path, corpus, monkeypatch, **kw)
    jeng.fit()
    eng.fit()
    agg = _compare_runs(jeng, eng, {"prog_denoise_result",
                                    "proj_denoise_result_2img"})
    n_proj = {"fbp": 3, "art": 4, "normal": 3, "benchmark": 1}[case]
    n_img = {"fbp": 3, "art": 7, "normal": 3, "benchmark": 1}[case]
    assert len(eng.proj_denoise_convert2img_result) == n_proj
    assert len(eng.progressive_denoise_result) == n_img
    assert f"psnr_iter_{n_proj}" in agg["deProj"]
    assert f"ssim_iter_{n_img}" in agg["deProg"]
    assert "psnr_iter_0_std" in agg["LDCT"] and not agg["deImg"]
    if case == "fbp":
        assert {"fsim_iter_1", "vif_iter_1", "nqm_iter_1"} <= set(
            agg["deProg"])
    assert set(eng.timer.totals) == {"load", "proj_stage+convert",
                                     "img_stage", "metrics", "save"}
    assert eng.timer.counts["img_stage"] == 2


@pytest.mark.parametrize("mode,store,metric", [
    ("test_img", "img_denoise_result", "deImg"),
    ("test_proj", "proj_denoise_result_2img", "deProj2img")])
def test_single_domain_modes_match_jax_engine(jax_engine, tmp_path, corpus,
                                              monkeypatch, mode, store,
                                              metric):
    jeng, eng, _ = _engines(jax_engine, tmp_path, corpus, monkeypatch,
                            mode=mode)
    assert (eng.proj_model is None) == (mode == "test_img")
    assert (eng.img_model is None) == (mode == "test_proj")
    jeng.fit()
    eng.fit()
    agg = _compare_runs(jeng, eng, {store})
    assert "psnr_iter_3" in agg[metric] and not agg["deProg"]


def test_checkpoints_load_round_trip_and_reference_layout(jax_engine,
                                                          tmp_path, corpus):
    ckpt = jax_engine[1]
    eng = _port_engine(ckpt, tmp_path, corpus)
    fresh = build_unet(eng.opt, "img", device="cpu")
    saved = torch.load(osp.join(ckpt.dir, "img_model-1"), weights_only=True)
    for k, v in eng.img_model.state_dict().items():
        assert torch.equal(v, saved[k])            # loaded, not the init's
    assert any(not torch.equal(v, fresh.state_dict()[k])
               for k, v in saved.items())
    # the engine's own save, read back into a new model
    eng.checkpoints(7)
    again = build_unet(eng.opt, "proj", device="cpu")
    assert eng.ckpt.load("proj_model", 7, again)
    for k, v in eng.proj_model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k])
    assert not eng.ckpt.load("proj_model", 8, again)   # no such file
    # a file in the original repo's layout (DataParallel's module. keys)
    torch.save({"module." + k: v for k, v in saved.items()},
               osp.join(ckpt.dir, "img_model-3"))
    assert ckpt.load("img_model", 3, fresh)
    for k, v in saved.items():
        assert torch.equal(v, fresh.state_dict()[k])
    torch.save({k: v for k, v in list(saved.items())[1:]},
               osp.join(ckpt.dir, "img_model-4"))
    with pytest.raises(RuntimeError, match="Missing key"):
        ckpt.load("img_model", 4, fresh)


def test_update_opt_reset_opt_and_option_json(jax_engine, tmp_path, corpus,
                                              monkeypatch):
    jeng, eng, _ = _engines(jax_engine, tmp_path, corpus, monkeypatch)
    option = osp.join(eng.logger.models_save_dir, "option.json")
    assert json.load(open(option))["convertor"] == "FBP"
    for e in (jeng, eng):
        e.update_opt({"convertor": "ART", "eta_img": 0.3, "bogus": 1})
        assert e.opt.convertor == "ART" and e.opt.eta_img == 0.3
        assert e.convertor.kind == "ART" and e.convertor.nstart == 2
        assert e.convertor.fbp_geom.grid_n == 32
    assert json.load(open(option))["eta_img"] == 0.3
    # the port builds its convertor anew on any option it is built from
    eng.update_opt({"sart_nstart": 3, "ntv": 1})
    assert eng.convertor.kind == "ART"
    assert (eng.convertor.nstart, eng.convertor.ntv) == (3, 1)
    kept = eng.convertor
    eng.update_opt({"eta_img": 0.3})
    assert eng.convertor is kept
    for e in (jeng, eng):
        e.reset_opt()
        assert e.opt.convertor == "FBP" and e.opt.eta_img == 0.7
        e.update_opt(None)
        assert e.opt.convertor == "FBP"


def test_proj_denoiser_return_and_store_semantics(jax_engine, tmp_path,
                                                  corpus, monkeypatch):
    """save_state / save_proj_state / convert / return_idx as the JAX
    engine's proj_denoiser and img_denoiser."""
    jeng, eng, _ = _engines(jax_engine, tmp_path, corpus, monkeypatch)
    ld_proj = eng.test_dataset[0][3][None]
    for e, x in ((jeng, jnp.asarray(ld_proj)), (eng, ld_proj)):
        e.data_sample_load(ldproj=ld_proj)
        img, ns = e.proj_denoiser(x, save_state=False, return_idx=0)
        assert ns is None and tuple(img.shape) == (1, 32, 32, 1)
        assert list(e.proj_denoise_convert2img_result) == ["iter_1"]
        assert not e.proj_denoise_result
        pj, _ = e.proj_denoiser(x, convert=False, save_proj_state=True,
                                return_idx=1)
        assert tuple(pj.shape) == (1, 90, 64, 1)
        assert list(e.proj_denoise_result) == ["iter_1", "iter_2", "iter_3"]
        np.testing.assert_array_equal(
            np.asarray(pj)[0, :, :, 0], e.proj_denoise_result[2][0, 0])
        out = e.img_denoiser(img, save_state=False, return_idx=0)
        assert list(e.progressive_denoise_result) == ["iter_1"]
        np.testing.assert_array_equal(
            np.asarray(out)[0, :, :, 0],
            e.progressive_denoise_result[-1][0, 0])
    np.testing.assert_allclose(eng.proj_denoise_result[2],
                               jeng.proj_denoise_result[2], rtol=1e-3,
                               atol=1e-4)


def test_plain_proj_denoiser_returns_every_iteration(jax_engine, tmp_path,
                                                     corpus, monkeypatch):
    """The plain function keeps every converted iteration, and
    make_convertor reads the geometry overrides."""
    eng = _port_engine(jax_engine[1], tmp_path, corpus, mode="test_proj")
    _zero_noise(monkeypatch)
    conv = make_convertor(eng.opt)
    assert (conv.fbp_geom.grid_n, conv.fbp_geom.M, conv.fbp_geom.N) == (
        32, 90, 64)
    assert make_convertor(dict(convertor="ART")).fbp_geom.grid_n == 512
    assert make_convertor(eng.opt, "TV").ntv == 1
    ld_proj = eng.test_dataset[1][3][None]
    imgs, ns = proj_denoiser(eng.opt, eng.proj_model, ld_proj, None,
                             device="cpu")
    assert len(imgs) == 3 and ns is None
    eng.proj_denoiser(torch.from_numpy(ld_proj))
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(
            img[0, :, :, 0].numpy(),
            eng.proj_denoise_convert2img_result[i + 1][0, 0])


@pytest.mark.parametrize("kw,err,match", [
    (dict(mode="test_prog", exact_fbp=True), NotImplementedError, "exact"),
    (dict(mode="test_prog", exact_art=True), NotImplementedError, "exact"),
    (dict(mode="test_prog", device="cuda"), RuntimeError, "CUDA"),
])
def test_engine_refuses_what_is_not_ported(tmp_path, corpus, monkeypatch, kw,
                                           err, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(BASE, **corpus, device="cpu", convertor="FBP")
    cfg.update(kw)
    with pytest.raises(err, match=match):
        ProgressiveDomainDenoiser(IPDMConfig(**cfg),
                                  result_save_path=str(tmp_path))


@pytest.mark.parametrize("kw,match", [
    (dict(display_result=True), "PNG"),
    (dict(sample_method_img="sparse"), "DDIM")])
def test_engine_run_refuses_png_grids_and_ddim(tmp_path, corpus, kw, match):
    cfg = dict(BASE, **corpus, device="cpu", convertor="FBP",
               mode="test_img", benchmark_test="PNG" in match)
    cfg.update(kw)
    eng = ProgressiveDomainDenoiser(IPDMConfig(**cfg),
                                    result_save_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match=match):
        eng.fit()

"""The port's engine in its train modes (ipdm_tpu_torch/engine/denoiser.py
ProgressiveDomainDenoiser with mode train_img / train_proj) on the CPU, at
a tiny size: twins of tests/test_engine.py's train_img end to end (:59),
train_proj (:181) and resume (:298) tests, the scalar stream's format
against the JAX ScalarWriter, the batch stream against the JAX engine's
on the same corpus, and the native prefetching loader against the
DataLoader."""

import itertools
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from ipdm_tpu.config.config import IPDMConfig as JaxConfig
from ipdm_tpu.engine.denoiser import ProgressiveDomainDenoiser as JaxEngine
from ipdm_tpu.engine.logging import ScalarWriter as JaxScalarWriter
from ipdm_tpu_torch.config.config import IPDMConfig
from ipdm_tpu_torch.data.dataset import SiemensDatasetNpz
from ipdm_tpu_torch.data.sampler import DataLoader, RandomSampler
from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
from ipdm_tpu_torch.engine.logging import ScalarWriter
from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
from ipdm_tpu_torch.recon.geometry import FanBeamGeometry
from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom
from ipdm_tpu_torch.recon.sart_fast import project_fast
from ipdm_tpu_torch.recon.simulate import add_noise
from ipdm_tpu_torch.utils import native

GEO = dict(nx=32, ny=32, dx=42 / 32, dy=42 / 32, nr=64,
           dr=0.0010125 * 912 / 64, na=90, ta_dimx=101, ta_dimy=46)
N_SLICES = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 32² slices in the four-stream layout: phantoms, the port's
    project_fast, add_noise at dose 0.25; the low-dose image is the
    phantom plus noise (the train modes read only the full-dose
    streams)."""
    root = tmp_path_factory.mktemp("train_corpus")
    geom = FanBeamGeometry(**GEO)
    g = fbp_geom_from_fan(geom)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    streams = ("fd_img", "ld_img", "fd_proj", "ld_proj")
    for s in streams:
        (root / s / "P001").mkdir(parents=True)
    for i in range(N_SLICES):
        vol = torch.from_numpy(random_ellipse_phantom(32, rng)[None].astype(
            np.float32))
        fd_proj = project_fast(vol, g, geom.nr, float(g.nda[0]), float(g.da))
        ld_proj = add_noise(fd_proj, gen, 0.25)
        ld_img = vol + 0.002 * torch.randn(vol.shape, generator=gen)
        for s, arr in zip(streams, (vol.transpose(1, 2), ld_img.transpose(
                1, 2), fd_proj, ld_proj)):
            np.save(root / s / "P001" / f"{i:04d}.npy", arr[0].numpy())
    paths = {}
    for kind in ("FD_img", "LD_img", "FD_proj", "LD_proj"):
        d = str(root / kind.lower())
        paths[f"test_dataset_path_{kind}"] = d
        if kind.startswith("FD"):
            paths[f"train_dataset_path_{kind}"] = d
    return paths

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



def _cfg(corpus, mode, **kw):
    """tests/test_engine.py's tiny models and schedule on this corpus."""
    cfg = dict(
        mode=mode, run_name="t", batch_size=2, test_batch_size=1,
        max_epochs=2, save_freq=2, test_numbers=0, init_lr=1e-3,
        convertor="FBP", fbp_sharpen=True, ultra_img_denoise=False,
        model_channels_img=8, channel_mult_img=[1, 1, 2],
        attention_resolutions_img=[4], timesteps_img=50,
        partial_timesteps_img=10, t_start_img=[3, 2],
        constant_guidance_img=0.45,
        model_channels_proj=8, channel_mult_proj=[1, 1, 2],
        attention_resolutions_proj=[4], timesteps_proj=50,
        partial_timesteps_proj=10, t_start_proj=[3, 2],
        constant_guidance_proj=0.5, metrics=["psnr", "ssim"], geometry=GEO,
        patch=[16, 16], patch_per_image=2, **corpus)
    cfg.update(kw)
    return cfg


def _engine(corpus, tmp_path, mode, sub="o", **kw):
    opt = IPDMConfig(device="cpu", **_cfg(corpus, mode, **kw))
    return ProgressiveDomainDenoiser(opt, result_save_path=str(tmp_path / sub))


def _scalars(eng):
    with open(osp.join(eng.save_root, "trainSummary", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_img_end_to_end(corpus, tmp_path):
    """train_img: max_iter from the corpus, Adam's step count, the model
    and optimizer checkpoints of every save_freq steps, option.json, the
    loss every 10 steps in scalars.jsonl, and test(it) on the trained
    module (metric.json, PSNR / SSIM scalars)."""
    eng = _engine(corpus, tmp_path, "train_img", batch_size=1, max_epochs=4,
                  save_freq=6, test_numbers=1)
    assert eng.opt.max_iter == 12   # 3 slices · 4 epochs // batch 1
    before = {k: v.clone() for k, v in eng.img_model.state_dict().items()}
    eng.fit()
    assert eng.img_model.remat and eng.proj_model is None
    assert int(eng.optimizer.state_dict()["state"][0]["step"]) == 12
    after = eng.img_model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    for it in (1, 2):
        for name in ("img_model", "optimizer"):
            assert osp.isfile(osp.join(eng.logger.models_save_dir,
                                       f"{name}-{it}"))
    # the last checkpoint holds the trained weights
    saved = torch.load(osp.join(eng.logger.models_save_dir, "img_model-2"),
                       weights_only=True)
    assert all(torch.equal(saved[k], after[k]) for k in saved)
    with open(osp.join(eng.logger.models_save_dir, "option.json")) as f:
        assert json.load(f)["mode"] == "train_img"
    lines = _scalars(eng)
    loss = [d for d in lines if d["tag"] == "train/loss"]
    assert [d["step"] for d in loss] == [1]
    assert np.isfinite(loss[0]["value"]) and loss[0]["value"] > 0
    assert {"deImg/psnr/psnr_iter_1", "LDCT/ssim/ssim_iter_0"} <= {
        d["tag"] for d in lines}
    with open(osp.join(eng.save_root_path, "Save_Iter_2",
                       "metric.json")) as f:
        m = json.load(f)
    assert np.isfinite(m["deImg"]["psnr_iter_1"])


def test_train_proj_end_to_end(corpus, tmp_path):
    """train_proj: the sinogram UNet trained on the full-dose sinograms,
    its checkpoint and the optimizer's, then test(it) through the FBP
    convert (deProj2img metrics)."""
    eng = _engine(corpus, tmp_path, "train_proj", batch_size=1,
                  max_epochs=1, save_freq=3, test_numbers=1, patch=None)
    assert eng.opt.max_iter == 3
    eng.fit()
    assert eng.img_model is None and eng.proj_model.remat
    assert int(eng.optimizer.state_dict()["state"][0]["step"]) == 3
    assert eng.ckpt.load("proj_model", 1, eng.proj_model)
    assert eng.ckpt.load_optimizer("optimizer", 1, eng.optimizer)
    with open(osp.join(eng.save_root_path, "Save_Iter_1",
                       "metric.json")) as f:
        m = json.load(f)
    assert {"psnr_iter_1", "psnr_iter_2", "psnr_iter_3"} <= set(
        m["deProj2img"])
    assert all(np.isfinite(v) for v in m["deProj2img"].values())


def test_resume_restores_model_optimizer_and_step(corpus, tmp_path):
    """A resumed train_img run loads img_model-1 into the model and
    optimizer-1 into Adam, bit for bit (moments nonzero, Adam's step the
    saved one), and restarts the stream at resume_iter = resume_epochs ·
    save_freq // batch_size (train_test_utils.py:362)."""
    eng = _engine(corpus, tmp_path, "train_img")
    eng.fit()
    assert eng.opt.max_iter == 3
    ckpt = eng.logger.models_save_dir
    eng2 = _engine(corpus, tmp_path, "train_img", sub="o2",
                   resume_epochs_img=1, load_img_model_path=ckpt)
    saved_m = torch.load(osp.join(ckpt, "img_model-1"), weights_only=True)
    state = eng2.img_model.state_dict()
    assert saved_m.keys() == state.keys()
    assert all(torch.equal(saved_m[k], state[k]) for k in saved_m)
    saved_o = torch.load(osp.join(ckpt, "optimizer-1"), weights_only=True)
    got = eng2.optimizer.state_dict()
    assert got["state"].keys() == saved_o["state"].keys()
    nonzero = False
    for i, s in saved_o["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"][i][k], s[k]), (i, k)
        nonzero |= bool(s["exp_avg"].abs().max() > 0)
    assert nonzero and int(saved_o["state"][0]["step"]) == 2
    assert eng2.opt.resume_iter == 1
    eng2.fit()    # iterations resume_iter + 1 .. max_iter: 2 and 3
    assert int(eng2.optimizer.state_dict()["state"][0]["step"]) == 4


def test_scalar_stream_matches_the_jax_writer(tmp_path):
    """scalars.jsonl lines: the JAX ScalarWriter's keys, value and step
    for the same calls (the time stamps differ); a TensorBoard event file
    beside them."""
    calls = [("train/loss", 0.25, 1), ("LDCT/psnr", {"psnr_iter_0": 30.5,
                                                     "psnr_iter_0_std": 0.0},
                                       2)]
    out = []
    for cls, d in ((ScalarWriter, tmp_path / "port"),
                   (JaxScalarWriter, tmp_path / "jax")):
        w = cls(str(d))
        for tag, val, step in calls:
            if isinstance(val, dict):
                w.add_scalars(tag, val, step)
            else:
                w.add_scalar(tag, val, step)
        w.close()
        with open(d / "scalars.jsonl") as f:
            out.append([json.loads(line) for line in f])
    assert len(out[0]) == len(out[1]) == 3
    for a, b in zip(*out):
        assert list(a) == list(b) == ["tag", "value", "step", "time"]
        assert (a["tag"], a["value"], a["step"]) == (b["tag"], b["value"],
                                                     b["step"])
    assert any(n.startswith("events.out.tfevents")
               for n in os.listdir(tmp_path / "port"))


@pytest.mark.parametrize("mode,native_loader", [
    ("train_img", False), ("train_img", True), ("train_proj", True)])
def test_batch_stream_equals_the_jax_engine(corpus, tmp_path, mode,
                                            native_loader, monkeypatch):
    """The first iterations' batches that fit() hands train() (the native
    loader where it applies, else the DataLoader), max_iter and
    resume_iter, against the JAX engine on the same files and options.
    The JAX engine's native loader runs with one worker here, as the
    port's does: with its two the library's in-order delivery can
    livelock (ipdm_tpu_torch/utils/native.py)."""
    from ipdm_tpu.utils import native as jnative
    one_worker = jnative.NativeLoader

    class OneWorker(one_worker):
        def __init__(self, *args, **kw):
            kw["n_threads"] = 1
            super().__init__(*args, **kw)

    monkeypatch.setattr(jnative, "NativeLoader", OneWorker)
    cfg = _cfg(corpus, mode, native_loader=native_loader, max_epochs=3,
               resume_epochs_img=0)
    eng = ProgressiveDomainDenoiser(IPDMConfig(device="cpu", **cfg),
                                    result_save_path=str(tmp_path / "p"))
    jeng = JaxEngine(JaxConfig(device="cpu", **cfg),
                     result_save_path=str(tmp_path / "j"))
    assert (eng.opt.max_iter, eng.opt.resume_iter) == (
        jeng.opt.max_iter, jeng.opt.resume_iter)
    streams = []
    for e in (eng, jeng):
        it = e._native_train_iter()
        assert (it is not None) == (native_loader and native.available())
        streams.append(list(itertools.islice(
            it if it is not None else iter(e.train_loader), 4)))
    assert len(streams[0]) == len(streams[1]) == 4
    stream = 1 if mode == "train_proj" else 2
    for got, want in zip(*streams):
        np.testing.assert_array_equal(got[stream], want[stream])
        assert got[stream].shape[1:] == (2, 16, 16, 1)   # patches


def test_native_loader_yields_the_data_loader_batches(corpus):
    """NativeLoader over the full-dose image files with the sampler's
    indices gives the DataLoader's batches of that stream."""
    if not native.available():
        pytest.skip("native/libipdm_native.so is not built (make -C native)")
    ds = SiemensDatasetNpz(fdimg_path=corpus["train_dataset_path_FD_img"],
                           patch=None)
    indices = list(RandomSampler(len(ds), batch_size=2, num_iter=4, seed=2))
    loader = native.NativeLoader(ds.fdimg_file_name, 32, 32, indices,
                                 batch=2)
    got = list(loader)
    loader.close()
    want = [b[2][..., 0] for b in DataLoader(
        ds, 2, sampler=RandomSampler(len(ds), batch_size=2, num_iter=4,
                                     seed=2))]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

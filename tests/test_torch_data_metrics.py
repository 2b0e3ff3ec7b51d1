"""The port's host-side modules against the JAX package's (both numpy /
scipy; the port keeps its own copy): the five image-quality metrics, the
four-stream dataset, the config system, the Yeo-Johnson normalisation,
the unit conversions, and the engine's dict helpers."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from ipdm_tpu import metrics as jax_metrics
from ipdm_tpu.config import config as jax_config
from ipdm_tpu.data import units as jax_units
from ipdm_tpu.data.dataset import SiemensDatasetNpz as JaxDataset
from ipdm_tpu.diffusion import normalize as jax_norm
from ipdm_tpu.engine import denoiser as jax_engine
from ipdm_tpu_torch import metrics
from ipdm_tpu_torch.config import config
from ipdm_tpu_torch.data import units
from ipdm_tpu_torch.data.dataset import SiemensDatasetNpz
from ipdm_tpu_torch.diffusion import normalize
from ipdm_tpu_torch.engine import denoiser as engine

ROOT = Path(__file__).resolve().parents[1]
PRESET = ROOT / "Config" / "Mayo-Config" / "test_progressive_option.json"


def _images(n=96):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:n, :n] / n
    fd = 0.25 + 0.2 * np.sin(6 * xx) * np.cos(4 * yy) + 0.1 * (xx > 0.5)
    ld = np.clip(fd + 0.03 * rng.standard_normal(fd.shape), 0, 1)
    return fd, ld


@pytest.mark.parametrize("name,kw", [
    ("psnr", dict(data_range=1)), ("ssim", dict(win_size=11, data_range=1)),
    ("fsim", dict(data_range=1)), ("vif_p", dict(data_range=1)),
    ("nqm", dict())])
def test_metric_matches_jax_package(name, kw):
    """The same numpy / scipy arithmetic in both packages: 1e-10."""
    fd, ld = _images()
    got = getattr(metrics, name)(fd, ld, **kw)
    want = getattr(jax_metrics, name)(fd, ld, **kw)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-10 * max(1.0, abs(want))
    closer = getattr(metrics, name)(fd, (fd + ld) / 2, **kw)
    assert closer > got       # half the noise scores better


def _write_corpus(root: Path):
    rng = np.random.default_rng(1)
    for stream, shape in (("fd_img", (8, 8)), ("ld_img", (8, 8)),
                          ("fd_proj", (12, 6)), ("ld_proj", (12, 6))):
        for patient, slices in (("P002", ("0001", "0000")),
                                ("P001", ("0003",))):
            d = root / stream / patient
            d.mkdir(parents=True)
            for sl in slices:
                np.save(d / f"{sl}.npy", rng.random(shape).astype(np.float32))
    return {k: str(root / s) for k, s in (
        ("ldimg_path", "ld_img"), ("fdimg_path", "fd_img"),
        ("ldproj_path", "ld_proj"), ("fdproj_path", "fd_proj"))}


@pytest.mark.parametrize("proj_clip", [False, True])
def test_dataset_matches_jax_package(tmp_path, proj_clip):
    paths = _write_corpus(tmp_path)
    ds = SiemensDatasetNpz(proj_clip=proj_clip, **paths)
    jds = JaxDataset(proj_clip=proj_clip, **paths)
    assert len(ds) == len(jds) == 3
    assert ds.patient_name == jds.patient_name == ["P001", "P002", "P002"]
    assert ds.slice_name == jds.slice_name == ["0003", "0000", "0001"]
    for i in range(3):
        for a, b in zip(ds[i], jds[i]):
            assert a.dtype == np.float32 and a.shape[-1] == 1
            np.testing.assert_array_equal(a, b)
    raw = np.load(tmp_path / "ld_proj" / "P001" / "0003.npy")
    np.testing.assert_array_equal(
        ds[0][3][..., 0], raw / 10.0 if proj_clip else raw)
    np.testing.assert_array_equal(
        ds[0][0][..., 0], np.load(tmp_path / "ld_img" / "P001" / "0003.npy"))
    only = SiemensDatasetNpz(ldproj_path=paths["ldproj_path"])
    assert only[1][0] is None and only[1][3].shape == (12, 6, 1)
    by_name = ds.get_data_from_name("P002", "0001")
    np.testing.assert_array_equal(by_name[2], ds[2][2])


def test_config_merges_the_mayo_preset_like_jax(capsys):
    preset = json.loads(PRESET.read_text())
    opt = config.IPDMConfig().merge(copy.deepcopy(preset))
    jopt = jax_config.IPDMConfig().merge(copy.deepcopy(preset))
    out = capsys.readouterr().out
    d, jd = opt.to_dict(), jopt.to_dict()
    # the port's own device; every other field, mesh_shape too, alike
    assert d.pop("device") == "cuda" and jd.pop("device") == "tpu"
    assert "device 'tpu' in config ignored" in out
    assert "mesh_shape" in d
    assert d == jd
    assert opt.convertor == "ART" and opt.t_start_img == [15, 15, 15]
    assert opt["eta_img"] == 0.7 and opt.get("nope", 3) == 3
    with pytest.raises(KeyError):
        opt["nope"]


def test_config_warns_on_unknown_and_tpu_only_keys(capsys):
    """Unknown keys warn; the JAX package's mesh_shape is a field of the
    port's too (the process mesh), from a preset and from the CLI, as
    JAX's default_cfg parses it."""
    opt = config.IPDMConfig().merge({"mesh_shape": [4, 2], "bogus": 1,
                                     "ntv": 3})
    out = capsys.readouterr().out
    assert "no key names bogus" in out and "mesh_shape" not in out
    assert opt.ntv == 3 and opt.mesh_shape == [4, 2]
    assert config.IPDMConfig().mesh_shape is None
    argv = ["--mesh_shape", "4", "2", "--mode", "test_prog",
            "--native_loader", "false"]
    cli = config.default_cfg(argv)
    out = capsys.readouterr().out
    assert "no key names" not in out
    assert cli.mesh_shape == jax_config.default_cfg(argv).mesh_shape == [4, 2]
    # the native prefetching loader is the training path's: a field now
    assert cli.mode == "test_prog"
    assert cli.native_loader is False and config.IPDMConfig().native_loader


def test_default_cfg_cli_wins_over_the_preset(capsys):
    argv = ["--load_option_path", str(PRESET), "--eta_img", "0.25",
            "--t_start_proj", "4", "5", "--device", "cpu",
            "--fbp_sharpen", "false"]
    opt = config.default_cfg(argv)
    jopt = jax_config.default_cfg(argv)
    capsys.readouterr()
    assert opt.eta_img == jopt.eta_img == 0.25
    assert opt.t_start_proj == jopt.t_start_proj == [4, 5]
    assert opt.device == "cpu" and opt.fbp_sharpen is False
    assert opt.convertor == jopt.convertor == "ART"      # from the preset
    assert opt.amplitude_img == jopt.amplitude_img == 30
    snap = opt.copy()
    opt.merge({"convertor": "FBP"})
    assert snap.convertor == "ART" and opt.convertor == "FBP"


def test_yeo_johnson_round_trip_and_parity():
    rng = np.random.default_rng(2)
    x = (rng.gamma(2.0, 0.1, (1, 24, 16, 1))).astype(np.float32)
    y, tr = normalize.yeo_johnson_transform(x)
    jy, jtr = jax_norm.yeo_johnson_transform(x)
    assert (tr.lmbda, tr.mean, tr.std) == (jtr.lmbda, jtr.mean, jtr.std)
    np.testing.assert_array_equal(y, jy)
    assert y.dtype == np.float32 and abs(float(y.mean())) < 1e-5
    assert abs(float(y.std()) - 1.0) < 1e-4
    back = normalize.yeo_johnson_inverse_transform(y, tr)
    # f32 storage of the Gaussianised values: 1e-5 of the data's range
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5 * float(x.max()))
    np.testing.assert_array_equal(
        back, jax_norm.yeo_johnson_inverse_transform(jy, jtr))


def test_units_take_numpy_like_the_jax_package():
    miu = np.random.default_rng(3).random((6, 5)).astype(np.float32) * 0.4
    got = units.miu2pixel(miu)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    # the same f32 expression, one evaluated by XLA: one ulp
    np.testing.assert_allclose(got, np.asarray(jax_units.miu2pixel(miu)),
                               rtol=0, atol=1.2e-7)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_dict_helpers_match_jax_engine():
    samples = [
        dict(LDCT=dict(psnr_iter_0=30.0, ssim_iter_0=0.8),
             deProg=dict(psnr_iter_1=31.0), deImg=dict()),
        dict(LDCT=dict(psnr_iter_0=28.0, ssim_iter_0=0.7),
             deProg=dict(psnr_iter_1=35.0), deImg=dict())]

    def total(mod):
        d, mean = mod.DotDict(), mod.DotDict()
        for m in copy.deepcopy(samples):
            mod.dict_add(mean, m, d)
        mod.dict_mean(mean, d)
        d = mod.DotDict()
        for m in copy.deepcopy(samples):
            mod.dict_value_minus_mean_square(m, mean, d)
        return mod.dict_std(mean, d)

    got, want = total(engine), total(jax_engine)
    assert got == want
    assert got["LDCT"]["psnr_iter_0"] == 29.0
    assert got["LDCT"]["psnr_iter_0_std"] == 1.0
    assert got.deProg.psnr_iter_1_std == 2.0
    store = engine.ResultTempDict()
    store["iter_1"], store["iter_2"] = "a", "b"
    assert store[1] == "a" and store[-1] == "b" and store.iter_2 == "b"
    with pytest.raises(AttributeError):
        engine.DotDict().missing

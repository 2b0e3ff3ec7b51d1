"""The port's PNG result grids (ipdm_tpu_torch/engine/denoiser.py
``result_figure_save``) and ``reset_window_centre`` against the JAX
package: on the same stored arrays, each of the four figure modes writes
its PNG, and the titles and PSNR / SSIM strings drawn on the axes
(captured from ``Axes.set_title`` / ``Axes.text`` on both sides) are the
JAX engine's; the metric dicts do not depend on ``only_metric``; without
matplotlib the grids are refused by name."""

import builtins
import os.path as osp

import jax.numpy as jnp
import matplotlib.axes
import numpy as np
import pytest

from ipdm_tpu.data import units as jax_units
from ipdm_tpu.engine import denoiser as jax_engine_mod
from ipdm_tpu_torch.data import units
from ipdm_tpu_torch.data.units import HU2miu, pixel2HU
from ipdm_tpu_torch.engine import denoiser as port_engine_mod

MODES = {"progressive": "progressive.png", "dimg": "deImg.png",
         "dproj2img": "deProj2img.png", "dproj": "dProj.png"}


@pytest.mark.parametrize("new,origin", [(None, None), ((-160, 240), None),
                                        ((-1000, 1000), (-1024, 3072)),
                                        ((0, 80), (-200, 400))])
def test_reset_window_centre_matches_jax(new, origin):
    img = np.random.default_rng(0).random((16, 16)).astype(np.float32)
    want = np.asarray(jax_units.reset_window_centre(jnp.asarray(img), new,
                                                    origin))
    got = units.reset_window_centre(img, new, origin)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert 0.0 <= got.min() and got.max() <= 1.0


def _engine(cls, save_path, metrics):
    """An engine object with the stores and samples result_figure_save
    reads, set directly: two converted proj iterations, three image
    iterations in each image store, three proj iterations, 24² images and
    30×16 sinograms made from a seed (μ near water, so the display window
    shows structure)."""
    rng = np.random.default_rng(4)
    eng = cls.__new__(cls)
    eng.opt = type("Opt", (), {"metrics": metrics})()
    eng.save_path = str(save_path)
    eng.metric_clear()

    def mu(scale):
        return HU2miu(pixel2HU(0.25 + scale * rng.random((1, 1, 24, 24))))

    fd = mu(0.02).astype(np.float32)
    eng.fdct = np.squeeze(units.miu2pixel(fd))
    eng.ldct_np = np.squeeze(units.miu2pixel(fd + 0.004 * rng.standard_normal(
        fd.shape))).astype(np.float32)
    eng.fdproj = rng.random((30, 16)).astype(np.float32) * 3
    eng.ldproj_np = eng.fdproj + 0.1 * rng.standard_normal((30, 16)).astype(
        np.float32)
    stores = {}
    for name, n, amp in (("proj_denoise_convert2img_result", 2, 0.003),
                         ("progressive_denoise_result", 3, 0.002),
                         ("img_denoise_result", 3, 0.001)):
        stores[name] = {f"iter_{i + 1}": (fd + amp * (i + 1)
                                          * rng.standard_normal(fd.shape)
                                          ).astype(np.float32)
                        for i in range(n)}
    stores["proj_denoise_result"] = {
        f"iter_{i + 1}": (eng.fdproj + 0.05 * (i + 1)
                          * rng.standard_normal((30, 16)))[None, None]
        for i in range(3)}
    for name, d in stores.items():
        setattr(eng, name, port_engine_mod.ResultTempDict(d))
    return eng


@pytest.fixture
def drawn(monkeypatch):
    """The titles and texts the axes receive, in order."""
    seen = []
    set_title = matplotlib.axes.Axes.set_title
    text = matplotlib.axes.Axes.text

    def title(ax, label, *a, **kw):
        seen.append(("title", label))
        return set_title(ax, label, *a, **kw)

    def txt(ax, *a, **kw):
        seen.append(("text", kw.get("s", a[2] if len(a) > 2 else None)))
        return text(ax, *a, **kw)

    monkeypatch.setattr(matplotlib.axes.Axes, "set_title", title)
    monkeypatch.setattr(matplotlib.axes.Axes, "text", txt)
    return seen


@pytest.mark.parametrize("mode", list(MODES))
def test_figure_modes_draw_what_jax_draws(tmp_path, drawn, mode):
    metrics = ["psnr", "ssim"]
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jeng = _engine(jax_engine_mod.ProgressiveDomainDenoiser, tmp_path / "j",
                   metrics)
    eng = _engine(port_engine_mod.ProgressiveDomainDenoiser, tmp_path / "p",
                  metrics)
    jeng.result_figure_save(mode=mode, display=False, only_metric=False)
    want = list(drawn)
    drawn.clear()
    eng.result_figure_save(mode=mode, display=False, only_metric=False)
    assert osp.getsize(tmp_path / "p" / MODES[mode]) > 1000
    assert osp.exists(tmp_path / "j" / MODES[mode])
    assert drawn == want and want
    if mode != "dproj":
        texts = [s for kind, s in drawn if kind == "text"]
        assert any("PSNR=" in s and "SSIM=" in s for s in texts)
        # the annotated values are the metric dict's, rounded
        mi = eng.metric_instance
        assert texts[0] == "PSNR={:.2f} , SSIM={:.2f}".format(
            mi["LDCT"]["psnr_iter_0"], mi["LDCT"]["ssim_iter_0"])
        assert eng.metric_instance == jeng.metric_instance


@pytest.mark.parametrize("mode", ["progressive", "dimg", "dproj2img"])
def test_only_metric_leaves_the_metrics_unchanged(tmp_path, mode):
    metrics = ["psnr", "ssim", "nqm"]
    a = _engine(port_engine_mod.ProgressiveDomainDenoiser, tmp_path,
                metrics)
    b = _engine(port_engine_mod.ProgressiveDomainDenoiser, tmp_path,
                metrics)
    a.result_figure_save(mode=mode, display=False, only_metric=True)
    assert not osp.exists(tmp_path / MODES[mode])
    b.result_figure_save(mode=mode, display=False, only_metric=False)
    assert osp.exists(tmp_path / MODES[mode])
    assert a.metric_instance == b.metric_instance
    assert a.metric_instance["LDCT"]["nqm_iter_0"] != 0


def test_grids_without_matplotlib_are_refused_by_name(tmp_path, monkeypatch):
    eng = _engine(port_engine_mod.ProgressiveDomainDenoiser, tmp_path,
                  ["psnr"])
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="display_result.*matplotlib"):
        eng.result_figure_save(mode="dimg", display=False, only_metric=False)
    eng.result_figure_save(mode="dimg", display=False, only_metric=True)
    assert "psnr_iter_1" in eng.metric_instance["deImg"]

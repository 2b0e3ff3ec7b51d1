"""The port's forward projector and low-dose simulation
(ipdm_tpu_torch/recon/{sart_fast,phantom,simulate}.py) against the JAX
package on a small scanner: 64² grid, 360 views of 128 detectors, where
the natural fine-grid refinement is Kf = 2 (pixel pitch 0.656 cm over a
t-bin of 0.37 cm), so the K-plane layout and its de-interleave run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.ops.pallas import shift as jax_shift
from ipdm_tpu.recon import phantom as jax_phantom
from ipdm_tpu.recon import sart_fast as jax_sf
from ipdm_tpu.recon import simulate as jax_sim
from ipdm_tpu.recon.convertor import fbp_geom_from_fan as jax_fbp_geom
from ipdm_tpu.recon.geometry import FanBeamGeometry as JaxFan
from ipdm_tpu_torch.recon import phantom, sart_fast, simulate
from ipdm_tpu_torch.recon.convertor import (Convertor, fbp_geom_from_fan,
                                            recons)
from ipdm_tpu_torch.recon.geometry import SIEMENS, FanBeamGeometry

FAN = dict(nx=64, ny=64, dx=42 / 64, dy=42 / 64, nr=128,
           dr=0.0010125 * 912 / 128, na=360, ta_dimx=401, ta_dimy=91)


def _volumes():
    rng = np.random.default_rng(0)
    return np.stack([phantom.random_ellipse_phantom(64, rng)
                     for _ in range(2)]).astype(np.float32)


def _jax_project(vol, monkeypatch, gather: bool):
    """JAX project_fast through its anterp_taps branch, or through its
    windowed-gather fallback (forced by shrinking the window bound the
    branch test reads)."""
    jg = jax_fbp_geom(JaxFan(**FAN))
    if gather:
        monkeypatch.setattr(jax_shift, "_WTR_D", 8)
    jax_sf._project_fast_fn.cache_clear()
    out = np.asarray(jax_sf.project_fast(jnp.asarray(vol), jg, 128,
                                         float(jg.nda[0]), float(jg.da)))
    jax_sf._project_fast_fn.cache_clear()
    return out


def test_geometry_and_plan_match_jax():
    g, jg = fbp_geom_from_fan(FanBeamGeometry(**FAN)), jax_fbp_geom(
        JaxFan(**FAN))
    for k in ("N", "M", "grid_n", "grid_l", "D", "da"):
        assert getattr(g, k) == getattr(jg, k)
    np.testing.assert_array_equal(g.nda, jg.nda)
    assert SIEMENS.replace(nx=64).nx == 64 and SIEMENS.nx == 512
    sp = sart_fast._splan_for(g, 1, fold=True)
    jsp = jax_sf._splan_for(jg, 1, fold=True)
    assert sp.Kf == jsp.Kf == 2
    for grp, jgrp in ((sp.gx_all, jsp.gx_all), (sp.gy_all, jsp.gy_all)):
        assert (grp.V, grp.Vpad, grp.K, grp.Lq, grp.L) == (
            jgrp.V, jgrp.Vpad, jgrp.K, jgrp.Lq, jgrp.L)
        tb = grp.tables("cpu")
        for name, want in zip(("s0", "s1", "frac"), jgrp.dev_row_tables()):
            np.testing.assert_allclose(tb[name].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tb["qvalid"].numpy(),
                                      np.asarray(jgrp.fine_tables()[3]))


@pytest.mark.parametrize("anterp", [True, False])
def test_project_fast_matches_jax(anterp, monkeypatch):
    """Both anterpolation forms of the port against the JAX branch of the
    same form. f32 sums of ≤ 2·64 deposits and 6 taps in another order on
    sinogram values up to ~3: 2e-5 of the largest value."""
    vol = _volumes()
    want = _jax_project(vol, monkeypatch, gather=not anterp)
    g = fbp_geom_from_fan(FanBeamGeometry(**FAN))
    got = sart_fast.project_fast(torch.from_numpy(vol), g, 128,
                                 float(g.nda[0]), float(g.da),
                                 anterp=anterp)
    assert got.shape == (2, 360, 128) and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert scale > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * scale)


def test_project_fast_forms_agree_and_invert():
    """The two forms give the same sinogram, and the OS-SART convert of it
    gives the phantom back (a physics check: ≥ 19 dB at 64²)."""
    vol = _volumes()[:1]
    g = fbp_geom_from_fan(FanBeamGeometry(**FAN))
    args = (torch.from_numpy(vol), g, 128, float(g.nda[0]), float(g.da))
    a = sart_fast.project_fast(*args, anterp=True)
    b = sart_fast.project_fast(*args, anterp=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=2e-5 * float(a.abs().max()))
    conv = Convertor("ART", geom=FanBeamGeometry(**FAN), nstart=4,
                     nsubsets=18)
    rec = conv(a)[0].numpy()
    ref = vol[0].T
    mse = float(np.mean((rec - ref) ** 2))
    psnr = 10 * np.log10(float(ref.max()) ** 2 / mse)
    assert psnr >= 19.0, psnr


def test_inverse_rebin_matches_jax():
    g, jg = fbp_geom_from_fan(FanBeamGeometry(**FAN)), jax_fbp_geom(
        JaxFan(**FAN))
    sp = sart_fast._splan_for(g, 1, fold=True)
    jsp = jax_sf._splan_for(jg, 1, fold=True)
    par = np.random.default_rng(3).random((2, 360, sp.p.Nt)).astype(
        np.float32)
    want = np.asarray(jax_sf._inverse_rebin(
        jnp.asarray(par), jsp.p, 128, float(jg.nda[0]), float(jg.da)))
    got = sart_fast._inverse_rebin(torch.from_numpy(par), sp.p, 128,
                                   float(g.nda[0]), float(g.da))
    # two lerps of f32 values in [0, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["shepp_logan", "miu_phantom",
                                  "random_ellipse_phantom"])
def test_phantoms_match_jax(name):
    if name == "random_ellipse_phantom":
        got = phantom.random_ellipse_phantom(48, np.random.default_rng(5))
        want = jax_phantom.random_ellipse_phantom(48,
                                                  np.random.default_rng(5))
    else:
        got = getattr(phantom, name)(48)
        want = getattr(jax_phantom, name)(48)
    assert got.shape == (48, 48)
    np.testing.assert_array_equal(got, want)


def test_add_noise_matches_jax_with_equal_noise(monkeypatch):
    """The noise model with the normal draw forced equal on both sides:
    f32 exp and sqrt of two libraries, 1e-6 relative."""
    data = (np.random.default_rng(7).random((2, 36, 16)) * 4).astype(
        np.float32)
    n = np.random.default_rng(8).standard_normal(data.shape).astype(
        np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(n))
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **kw: torch.from_numpy(n))
    want = np.asarray(jax_sim.add_noise(jnp.asarray(data), None, 0.25))
    got = simulate.add_noise(torch.from_numpy(data), None, 0.25)
    assert float(np.abs(want - data).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_add_noise_generator_and_exact_branch():
    """The noise follows the generator; the exact branch (refused before
    the exact physics was ported) returns the footprint SART's
    ``recons`` of the noisy sinogram."""
    data = torch.full((4, 8), 2.0)
    a = simulate.add_noise(data, torch.Generator().manual_seed(1), 0.25)
    b = simulate.add_noise(data, torch.Generator().manual_seed(1), 0.25)
    c = simulate.add_noise(data, torch.Generator().manual_seed(2), 0.25)
    assert torch.equal(a, b) and not torch.equal(a, c)
    geom = FanBeamGeometry(**FAN)
    clean = torch.from_numpy(np.abs(np.random.default_rng(2).standard_normal(
        (1, geom.na, geom.nr))).astype(np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # thousands of small ops: no pool to thrash
    try:
        noisy, img = simulate.simulate_ldct_batch(
            clean, torch.Generator().manual_seed(3), geom=geom, nstart=1,
            nsubsets=4, exact=True)
        assert torch.equal(noisy, simulate.add_noise(
            clean, torch.Generator().manual_seed(3), 0.25))
        assert img.shape == (1, geom.nx, geom.ny)
        assert torch.equal(img, recons(noisy, geom, nstart=1, nsubsets=4))
    finally:
        torch.set_num_threads(threads)

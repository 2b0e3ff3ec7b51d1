"""The port's fast OS-SART (ipdm_tpu_torch/recon/sart_fast.py) against the
JAX package's fused path (ipdm_tpu/recon/sart_fast.py, Pallas kernels in
interpret mode) on a small geometry: 64² grid, 360 views of 128
detectors, 6 ordered subsets, 2 sweeps, a batch of 2 sinograms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.recon import sart_fast as jax_sf
from ipdm_tpu.recon.fbp import FBPGeometry as JaxGeometry
from ipdm_tpu_torch.recon import sart_fast
from ipdm_tpu_torch.recon.convertor import Convertor
from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry

SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)


def _sinograms():
    return np.random.default_rng(0).random((2, 360, 128)).astype(np.float32)


@pytest.mark.parametrize("ntv", [0, 2])
def test_sart_fast_convert_matches_jax(ntv):
    pj = _sinograms()
    want = np.asarray(jax_sf.sart_fast_convert(
        jnp.asarray(pj), JaxGeometry(**SMALL), nstart=2, ntv=ntv,
        nsubsets=6))
    got = sart_fast.sart_fast_convert(torch.from_numpy(pj),
                                      FBPGeometry(**SMALL), nstart=2,
                                      ntv=ntv, nsubsets=6)
    assert got.shape == (2, 64, 64) and got.dtype == torch.float32
    # f32 FP/BP sums in another order over 2 sweeps of 12 subsets, and
    # the TV steps' f32 transcendentals: relative to the image
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=2e-4 * scale)


def test_resample_to_fine_matches_both_jax_branches():
    """The port's one anterp_taps resample against the JAX anterp_taps
    branch and its take_along_axis branch, on the live fine rays (the
    tail past Lq is masked by the caller)."""
    jsp = jax_sf._splan_for(JaxGeometry(**SMALL), 6, fold=True, kf=1)
    sp = sart_fast._splan_for(FBPGeometry(**SMALL), 6, fold=True, kf=1)
    R = np.random.default_rng(1).random(
        (2, len(sp.view_ids), sp.p.Nt)).astype(np.float32)
    for jgrp, grp in ((jsp.gx_all, sp.gx_all), (jsp.gy_all, sp.gy_all)):
        assert (grp.V, grp.Vpad, grp.L) == (jgrp.V, jgrp.Vpad, jgrp.L)
        assert jgrp.K * jgrp.Lq == grp.Lq
        live = grp.Lq
        got = sp.resample_to_fine(torch.from_numpy(R), grp).numpy()
        anterp = np.asarray(jsp._resample_to_fine(jnp.asarray(R), jgrp))
        rv = jnp.swapaxes(jnp.asarray(R)[:, jnp.asarray(jgrp.local_ids)],
                          0, 1)
        rv = jnp.pad(rv, ((0, jgrp.Vpad - jgrp.V), (0, 0), (0, 0)))
        gather = np.asarray(jsp._resample_to_fine_gather(rv, jgrp, 2))
        # two-tap lerps: one f32 rounding apart at most
        for want in (anterp, gather):
            np.testing.assert_allclose(got[..., :live], want[..., :live],
                                       rtol=0, atol=1e-6)


def test_siemens_plan_matches_jax_and_stays_in_its_windows():
    """At SIEMENS_FBP (folded, 40 subsets, Kf=1) the port plans the JAX
    package's drive subsets, and every sweep window stays inside L (the
    bound the sweep wrapper checks: 0 <= s0, s0 + n < L)."""
    jsp = jax_sf._splan_for(JaxGeometry(), 40, fold=True, kf=1)
    sp = sart_fast._splan_for(SIEMENS_FBP, 40, fold=True, kf=1)
    assert len(sp.view_ids) == 1000 and sp.p.Nt == 912
    for key in ("x", "y"):
        S, Vp, idx = sp.dsub[key]
        jS, jVp, jidx = jsp.dsub[key]
        assert (S, Vp) == (jS, jVp) == (32, 16)
        np.testing.assert_array_equal(idx, jidx)
        s0, s1, frac = sp.fused_tables(key, "cpu")
        grp = sp.group(key)
        assert grp.L == 1408
        assert int(s0.min()) >= 0 and int(s0.max()) + sp.p.n < grp.L
        lo, hi = grp.bounds("s0")
        assert lo >= 0 and hi + sp.p.n < grp.L
        lo, hi = grp.bounds("rqi")
        assert lo >= 0 and hi + 1 < sp.p.Nt + 1   # the resample's 2 taps
        live = torch.from_numpy(idx >= 0)   # pad entries hold s0 = s1 = 0
        assert torch.equal(s1[live], s0[live] + 1)
        assert float(frac.min()) >= 0.0 and float(frac.max()) < 1.0


def test_convertor_art_and_tv():
    """Convertor("ART") is sart_fast_convert with the reference's subset
    rule (lowered until it divides the view count); "TV" adds at least
    one TV step per sweep."""
    g = FBPGeometry(**SMALL)
    pj = torch.from_numpy(_sinograms())
    art = Convertor("ART", g, nstart=2, nsubsets=7)
    assert art.nsubsets == 6 and art.ntv == 0
    torch.testing.assert_close(
        art(pj), sart_fast.sart_fast_convert(pj, g, nstart=2, nsubsets=6),
        rtol=0, atol=0)
    tv = Convertor("TV", g, nstart=2, nsubsets=6)
    assert tv.ntv == 1
    torch.testing.assert_close(
        tv(pj), sart_fast.sart_fast_convert(pj, g, nstart=2, ntv=1,
                                            nsubsets=6), rtol=0, atol=0)
    with pytest.raises(ValueError):
        Convertor("SART")

"""The port's unfused OS-SART (``sart_fast_convert(fused=False)``,
ipdm_tpu_torch/recon/sart_fast.py) against the JAX package's
(ipdm_tpu/recon/sart_fast.py, Pallas kernels in interpret mode) on a
small geometry (64² grid, 360 views of 128 detectors, 3 ordered subsets,
2 sweeps with a TV step each, a batch of 2 sinograms): the natural-Kf
plan's per-subset view groups (also at SIEMENS_FBP, folded and not), the
resample of the measured ratios onto their two-plane fine grids, the
static norms and the convert. JAX's norms and convert run once, in a
module fixture. Then, in the port alone, the JAX package's own cross-check
of the fused sweep on a projected phantom.

The convert's input is two projected random-ellipse phantoms, the kind
of sinogram the JAX package's own unfused checks use. On uniform random
sinograms the rays that graze the grid's corners have ray norms n_t near
0 and so ratios R = m_t / n_t many orders of magnitude above the rest;
the JAX convert's jitted backprojection sums those in another order than
its own eager run, which moves a few corner pixels of the JAX image by
more than the parity rule (the port follows the eager run)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.recon import sart_fast as jax_sf
from ipdm_tpu.recon.fbp import FBPGeometry as JaxGeometry
from ipdm_tpu_torch.recon import sart_fast
from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry
from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom, shepp_logan

SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)
NSUB = 3



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: an unfused convert is thousands of small
    PyTorch ops, which thrash when every test worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _project(vol: np.ndarray) -> np.ndarray:
    """[B, 64, 64] phantoms → [B, 360, 128] sinograms (the port's
    project_fast, which tests/test_torch_project_fast.py holds to JAX's)."""
    g = FBPGeometry(**SMALL)
    return sart_fast.project_fast(torch.from_numpy(vol.astype(np.float32)),
                                  g, g.N, float(g.nda[0]),
                                  float(g.da)).numpy()


@pytest.fixture(scope="module")
def jax_unfused():
    """JAX's natural-Kf plan at SMALL (folded, NSUB subsets), its unfused
    norms, two projected phantoms and JAX's unfused convert of them,
    computed once."""
    g = JaxGeometry(**SMALL)
    rng = np.random.default_rng(0)
    vol = np.stack([random_ellipse_phantom(64, rng) for _ in range(2)])
    pj = _project(vol)
    jsp = jax_sf._splan_for(g, NSUB, fold=True)
    norms = jax_sf._norms_for(jsp, fused=False)
    img = np.asarray(jax_sf.sart_fast_convert(
        jnp.asarray(pj), g, nstart=2, ntv=1, nsubsets=NSUB, fused=False))
    return jsp, norms, pj, img


def _plan_pair(geom: str, fold: bool):
    if geom == "small":
        jg, g, nsub = JaxGeometry(**SMALL), FBPGeometry(**SMALL), NSUB
    else:
        jg, g, nsub = JaxGeometry(), SIEMENS_FBP, 40
    return (jax_sf._splan_for(jg, nsub, fold=fold),
            sart_fast._splan_for(g, nsub, fold=fold))


@pytest.mark.parametrize("geom,fold", [("small", True), ("small", False),
                                       ("siemens", True),
                                       ("siemens", False)])
def test_subset_groups_match_jax(geom, fold):
    """Every subset's (x-driven, y-driven) pair at the natural Kf = 2: the
    same sinogram rows, padding and fine-grid length; and on the first
    subset's pair (JAX builds the tables on its device, ~1 s a group),
    the same row tables (s0, s1, frac) and live-ray mask."""
    jsp, sp = _plan_pair(geom, fold)
    assert sp.Kf == jsp.Kf == 2
    assert sp.nsubsets == jsp.nsubsets
    np.testing.assert_array_equal(sp.order, jsp.order)
    assert len(sp.groups) == len(jsp.groups) == sp.nsubsets
    for s, (pair, jpair) in enumerate(zip(sp.groups, jsp.groups)):
        for grp, jgrp in zip(pair, jpair):
            assert grp.xdrive == jgrp.xdrive
            np.testing.assert_array_equal(grp.local_ids, jgrp.local_ids)
            assert ((grp.V, grp.Vpad, grp.K, grp.Lq, grp.L)
                    == (jgrp.V, jgrp.Vpad, jgrp.K, jgrp.Lq, jgrp.L))
            if s:
                continue
            tb = grp.tables("cpu")
            for name, want in zip(("s0", "s1", "frac"),
                                  jgrp.dev_row_tables()):
                np.testing.assert_array_equal(tb[name].numpy(),
                                              np.asarray(want), name)
            np.testing.assert_array_equal(
                tb["qvalid"].numpy(), np.asarray(jgrp.fine_tables()[3]))


def test_resample_to_fine_kf2_matches_both_jax_branches(jax_unfused):
    """The one anterp_taps resample onto a group's two-plane fine grid
    against JAX's anterp_taps branch and its take_along_axis branch, on
    the live fine rays (the tail past K·Lq is masked by the caller), for
    the first subset's two groups."""
    jsp = jax_unfused[0]
    sp = sart_fast._splan_for(FBPGeometry(**SMALL), NSUB, fold=True)
    R = np.random.default_rng(1).random(
        (2, len(sp.view_ids), sp.p.Nt)).astype(np.float32)
    for grp, jgrp in zip(sp.groups[0], jsp.groups[0]):
        live = grp.K * grp.Lq
        got = sp.resample_to_fine(torch.from_numpy(R), grp).numpy()
        assert got.shape == (grp.Vpad, 2, grp.L)
        anterp = np.asarray(jsp._resample_to_fine(jnp.asarray(R), jgrp))
        rv = jnp.swapaxes(
            jnp.asarray(R)[:, jnp.asarray(jgrp.local_ids)], 0, 1)
        rv = jnp.pad(rv, ((0, jgrp.Vpad - jgrp.V), (0, 0), (0, 0)))
        gather = np.asarray(jsp._resample_to_fine_gather(rv, jgrp, 2))
        # two-tap lerps: one f32 rounding apart at most
        for want in (anterp, gather):
            np.testing.assert_allclose(got[..., :live], want[..., :live],
                                       rtol=0, atol=1e-6)


def test_unfused_norms_match_jax(jax_unfused):
    """nt_full, each subset branch's (1/n_fine, live mask) and the subset
    BP norms: f32 sums of the same terms in another order."""
    jsp, (jnt, jfine, jbp), _, _ = jax_unfused
    sp = sart_fast._splan_for(FBPGeometry(**SMALL), NSUB, fold=True)
    nt, fine, bp = sart_fast._norms_for(sp, "cpu", fused=False)
    assert sart_fast._norms_for(sp, "cpu", fused=False)[0] is nt
    np.testing.assert_allclose(nt.numpy(), np.asarray(jnt), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jnt).max()))
    for branches, jbranches in zip(fine, jfine):
        for (inv_nf, valid), (jinv, jvalid) in zip(branches, jbranches):
            np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
            np.testing.assert_allclose(inv_nf.numpy(), np.asarray(jinv),
                                       rtol=1e-5, atol=0)
    assert bp.shape == (NSUB, 64, 64)
    np.testing.assert_allclose(bp.numpy(), np.asarray(jbp), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jbp).max()))


def test_unfused_convert_matches_jax(jax_unfused):
    _, _, pj, want = jax_unfused
    got = sart_fast.sart_fast_convert(
        torch.from_numpy(pj), FBPGeometry(**SMALL), nstart=2, ntv=1,
        nsubsets=NSUB, fused=False, mm_bf16=True)
    assert got.shape == (2, 64, 64) and got.dtype == torch.float32
    # f32 FP/BP sums in another order over 2 sweeps of 6 subset branches,
    # and the TV steps' f32 transcendentals: relative to the image
    # (mm_bf16 is ignored by the unfused sweep, as in JAX)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=2e-4 * float(np.abs(want).max()))


def _psnr(a, b):
    """tests/test_sart_fast.py's PSNR: the range of ``a`` over the RMS."""
    err = np.mean((a - b) ** 2)
    rng = max(a.max() - a.min(), 1e-9)
    return 10 * np.log10(rng ** 2 / err)


def test_unfused_matches_fused_on_a_phantom():
    """The JAX package's cross-check of the fused sweep
    (tests/test_sart_fast.py test_mm_sweep_matches_unfused) in the port: on
    a Shepp-Logan phantom projected by project_fast, the fused and the
    unfused sweep reconstruct the same image (PSNR > 25 dB, scale within
    5%), and the fused one recovers the phantom."""
    g = FBPGeometry(**SMALL)
    ph = shepp_logan(64).astype(np.float32) * 0.03
    pj = sart_fast.project_fast(torch.from_numpy(ph[None]), g, g.N,
                                float(g.nda[0]), float(g.da))
    old, new = (sart_fast.sart_fast_convert(pj, g, nstart=8, nsubsets=18,
                                            fused=fused)[0].numpy()
                for fused in (False, True))
    c = 4
    old, new = old[c:-c, c:-c], new[c:-c, c:-c]
    assert _psnr(old, new) > 25.0
    assert _psnr(ph.T[c:-c, c:-c], new) > 17.0
    scale = np.sum(new * old) / np.sum(old ** 2)
    assert abs(scale - 1.0) < 0.05, scale

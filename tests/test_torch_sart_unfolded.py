"""The port's OS-SART on the unfolded view set (``sart_fast_convert(...,
fold=False)``, ipdm_tpu_torch/recon/sart_fast.py): the fused convert
against the JAX package's (ipdm_tpu/recon/sart_fast.py, Pallas kernels in
interpret mode) on a small geometry (64² grid, 360 views of 128
detectors, 6 ordered subsets, 2 sweeps with a TV step each, a batch of 2
sinograms; JAX's convert runs once, in a module fixture); the fused
plan's drive subsets at SIEMENS_FBP unfolded; then, in the port alone,
the JAX package's own check that folding the half turns reconstructs
the same image, for the fused and the unfused sweep."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.recon import sart_fast as jax_sf
from ipdm_tpu.recon.fbp import FBPGeometry as JaxGeometry
from ipdm_tpu_torch.recon import sart_fast
from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry
from ipdm_tpu_torch.recon.phantom import shepp_logan

SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: an unfused convert is thousands of small
    PyTorch ops, which thrash when every test worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sinograms():
    return np.random.default_rng(0).random((2, 360, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_unfolded():
    """JAX's fused convert of _sinograms() on the unfolded view set."""
    return np.asarray(jax_sf.sart_fast_convert(
        jnp.asarray(_sinograms()), JaxGeometry(**SMALL), nstart=2, ntv=1,
        nsubsets=6, fold=False))


def test_fused_unfolded_convert_matches_jax(jax_unfolded):
    got = sart_fast.sart_fast_convert(
        torch.from_numpy(_sinograms()), FBPGeometry(**SMALL), nstart=2,
        ntv=1, nsubsets=6, fold=False)
    want = jax_unfolded
    assert got.shape == (2, 64, 64) and got.dtype == torch.float32
    # f32 FP/BP sums in another order over 2 sweeps of 2·12 subsets, and
    # the TV steps' f32 transcendentals: relative to the image
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=2e-4 * float(np.abs(want).max()))


def test_siemens_unfolded_plan_matches_jax():
    """At SIEMENS_FBP unfolded (2000 views, 40 subsets, Kf = 1) each drive's
    1000 views split into 63 fused subsets of ≤ 16, as in JAX, and every
    sweep window stays inside L."""
    jsp = jax_sf._splan_for(JaxGeometry(), 40, fold=False, kf=1)
    sp = sart_fast._splan_for(SIEMENS_FBP, 40, fold=False, kf=1)
    assert len(sp.view_ids) == 2000
    for key in ("x", "y"):
        S, Vp, idx = sp.dsub[key]
        jS, jVp, jidx = jsp.dsub[key]
        assert (S, Vp) == (jS, jVp) == (63, 16)
        np.testing.assert_array_equal(idx, jidx)
        grp = sp.group(key)
        np.testing.assert_array_equal(grp.local_ids,
                                      jsp.gx_all.local_ids if key == "x"
                                      else jsp.gy_all.local_ids)
        assert grp.L == 1408
        lo, hi = grp.bounds("s0")
        assert lo >= 0 and hi + sp.p.n < grp.L


def _psnr(a, b):
    """tests/test_sart_fast.py's PSNR: the range of ``a`` over the RMS."""
    err = np.mean((a - b) ** 2)
    rng = max(a.max() - a.min(), 1e-9)
    return 10 * np.log10(rng ** 2 / err)


@pytest.mark.parametrize("fused", [True, False])
def test_fold_matches_unfolded(fused):
    """The JAX package's fold check (tests/test_sart_fast.py
    test_fold_matches_unfolded) in the port: on a Shepp-Logan phantom
    projected by project_fast, the folded and the unfolded view sets
    reconstruct the same image (PSNR > 30 dB), with either sweep."""
    g = FBPGeometry(**SMALL)
    ph = shepp_logan(64).astype(np.float32) * 0.03
    pj = sart_fast.project_fast(torch.from_numpy(ph[None]), g, g.N,
                                float(g.nda[0]), float(g.da))
    folded, unfolded = (sart_fast.sart_fast_convert(
        pj, g, nstart=4, nsubsets=18, fold=fold, fused=fused)[0].numpy()
        for fold in (True, False))
    c = 4
    assert _psnr(unfolded[c:-c, c:-c], folded[c:-c, c:-c]) > 30.0

"""The port's exact physics (ipdm_tpu_torch/recon/{fbp,sart,convertor,
simulate}.py: the direct fan-beam FBP, the footprint OS-SART, ``recons``,
``project``, the exact ``Convertor`` and ``simulate_ldct_batch(exact=True)``)
against the JAX package on the small fan-beam geometry of
tests/test_recon.py (64², 128 detectors, 180 views). Each comparison uses
1e-5·max|ref| + 1e-4·|ref| and stands beside a planted fault that misses
it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.recon import convertor as JC
from ipdm_tpu.recon import fbp as JF
from ipdm_tpu.recon import geometry as JG
from ipdm_tpu.recon import projector as JP
from ipdm_tpu.recon import sart as JS
from ipdm_tpu.recon import simulate as JSIM
from ipdm_tpu.recon.phantom import shepp_logan
from ipdm_tpu_torch.recon import convertor as C
from ipdm_tpu_torch.recon import fbp as F
from ipdm_tpu_torch.recon import geometry as G
from ipdm_tpu_torch.recon import sart as S
from ipdm_tpu_torch.recon import simulate as SIM

SMALL_KW = dict(nx=64, ny=64, dx=42.0 / 64, dy=42.0 / 64, nr=128,
                dr=0.0010125 * 912 / 128, na=180, ta_dimx=401, ta_dimy=91)
JSMALL = JG.FanBeamGeometry(**SMALL_KW)
SMALL = G.FanBeamGeometry(**SMALL_KW)
LUT = G.area_lut(SMALL)
BETAS = G.default_betas(SMALL)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the exact physics is thousands of small
    PyTorch ops, which thrash when every test worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(got, want):
    """max |got − want| over 1e-5·max|want| + 1e-4·|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 * np.abs(want).max() + 1e-4 * np.abs(want)
    return float((np.abs(got - want) / tol).max())


@pytest.fixture(scope="module")
def sinos():
    """Two sinograms [2, 180, 128] of scaled Shepp-Logan phantoms (the
    second rotated), from the JAX projector."""
    ph = np.asarray(shepp_logan(64), np.float32) * 0.02
    vols = np.stack([ph, np.rot90(ph).copy() * 0.8])
    return np.stack([np.asarray(JP.forward_project(
        jnp.asarray(v), JSMALL, jnp.asarray(LUT), jnp.asarray(BETAS)))
        for v in vols])


def _drop_view(pj, v=4):
    """The planted fault: one view of the first sinogram lost (an even
    view, which every sample rate here keeps)."""
    pj = pj.copy()
    pj[0, v] = 0
    return pj


def test_ramp_filter_matches_jax():
    g = C.fbp_geom_from_fan(SMALL)
    x = np.random.default_rng(0).standard_normal((2, 180, 128)).astype(
        np.float32)
    want = np.asarray(JF.ramp_filter(jnp.asarray(x), jnp.asarray(g.h_RL),
                                     g.N))
    got = F.ramp_filter(torch.from_numpy(x), g.h_RL, g.N)
    assert got.shape == want.shape
    assert _over(got, want) <= 1.0
    planted = F.ramp_filter(torch.from_numpy(_drop_view(x)), g.h_RL, g.N)
    assert _over(planted, want) > 1.0


def test_fbp_convert_matches_jax(sinos):
    jg, g = JC.fbp_geom_from_fan(JSMALL), C.fbp_geom_from_fan(SMALL)
    want = np.asarray(JF.fbp_convert(jnp.asarray(sinos), jg))
    got = F.fbp_convert(torch.from_numpy(sinos), g)
    assert got.shape == (2, 64, 64)
    assert _over(got, want) <= 1.0
    # another view block, and no flip on the way out
    assert _over(F.fbp_convert(torch.from_numpy(sinos), g, view_block=7),
                 want) <= 1.0
    assert _over(F.fbp_convert(torch.from_numpy(_drop_view(sinos)), g),
                 want) > 1.0
    want_nf = np.asarray(JF.fbp_convert(jnp.asarray(sinos), jg, flip=False))
    assert _over(F.fbp_convert(torch.from_numpy(sinos), g, flip=False),
                 want_nf) <= 1.0


@pytest.mark.parametrize("ntv,sample_rate", [(0, 1), (0, 2), (1, 1),
                                             (1, 2)])
def test_sart_reconstruct_matches_jax(sinos, ntv, sample_rate):
    """nstart 2, 10 interleaved subsets: the post-SART snapshot of the
    last sweep, through the TV steps' α / σ rules when ntv > 0."""
    kw = dict(nstart=2, ntv=ntv, nsubsets=10, sample_rate=sample_rate)
    want = np.asarray(JS.sart_reconstruct(
        jnp.asarray(sinos[0]), JSMALL, jnp.asarray(LUT), jnp.asarray(BETAS),
        **kw))
    got = S.sart_reconstruct(torch.from_numpy(sinos[0]), SMALL, LUT, BETAS,
                             **kw)
    assert got.shape == (64, 64)
    assert _over(got, want) <= 1.0
    planted = S.sart_reconstruct(torch.from_numpy(_drop_view(sinos)[0]),
                                 SMALL, LUT, BETAS, **kw)
    assert _over(planted, want) > 1.0


def test_sart_rejects_a_subset_count_that_does_not_divide():
    with pytest.raises(ValueError, match="divide"):
        S.sart_reconstruct(torch.zeros(180, 128), SMALL, LUT, BETAS,
                           nstart=1, nsubsets=7)


@pytest.mark.parametrize("permute", [True, False])
def test_recons_matches_jax(sinos, permute):
    """A batch of two, with and without the binding's transpose."""
    kw = dict(nstart=2, ntv=1, nsubsets=12, permute=permute)
    want = np.asarray(JC.recons(jnp.asarray(sinos), JSMALL, **kw))
    got = C.recons(torch.from_numpy(sinos), SMALL, **kw)
    assert got.shape == (2, 64, 64)
    assert _over(got, want) <= 1.0
    # the other orientation misses
    assert _over(got.transpose(1, 2), want) > 1.0


@pytest.mark.parametrize("kind,exact", [("FBP", "exact_fbp"),
                                        ("ART", "exact_art"),
                                        ("TV", "exact_art")])
def test_exact_convertor_matches_jax(sinos, kind, exact):
    kw = {exact: True, "nstart": 2, "nsubsets": 12}
    jconv = JC.Convertor(kind, geom=JSMALL, **kw)
    conv = C.Convertor(kind, geom=SMALL, **kw)
    assert conv.ntv == jconv.ntv and conv.nsubsets == jconv.nsubsets
    np.testing.assert_array_equal(conv.lut, np.asarray(jconv.lut))
    np.testing.assert_array_equal(conv.betas, np.asarray(jconv.betas))
    want = np.asarray(jconv.convert(jnp.asarray(sinos)))
    got = conv.convert(torch.from_numpy(sinos))
    assert got.shape == (2, 64, 64)
    assert _over(got, want) <= 1.0
    assert _over(conv(torch.from_numpy(_drop_view(sinos))), want) > 1.0


def test_convertor_project_matches_jax():
    vol = np.random.default_rng(3).random((2, 64, 64)).astype(np.float32)
    want = np.asarray(JC.Convertor("ART", geom=JSMALL).project(
        jnp.asarray(vol)))
    got = C.Convertor("ART", geom=SMALL).project(torch.from_numpy(vol))
    assert got.shape == (2, 180, 128)
    assert _over(got, want) <= 1.0
    assert _over(C.project(torch.from_numpy(vol), SMALL), want) <= 1.0
    planted = got.clone()
    planted[1, 90] = 0
    assert _over(planted, want) > 1.0


def test_simulate_ldct_batch_exact_matches_jax(sinos, monkeypatch):
    """One noisy input, the normal draw forced equal on both sides."""
    n = np.random.default_rng(8).standard_normal((1, 180, 128)).astype(
        np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(n))
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **kw: torch.from_numpy(n))
    kw = dict(dose=0.25, nstart=2, nsubsets=10, exact=True)
    jnoisy, jimg = JSIM.simulate_ldct_batch(jnp.asarray(sinos[:1] * 50),
                                            None, geom=JSMALL, **kw)
    noisy, img = SIM.simulate_ldct_batch(torch.from_numpy(sinos[:1] * 50),
                                         None, geom=SMALL, **kw)
    assert _over(noisy, jnoisy) <= 1.0
    assert img.shape == (1, 64, 64)
    assert _over(img, jimg) <= 1.0
    torch.testing.assert_close(img, C.recons(noisy, SMALL, nstart=2,
                                             nsubsets=10), rtol=0, atol=0)
    clean = C.recons(torch.from_numpy(sinos[:1] * 50), SMALL, nstart=2,
                     nsubsets=10)
    assert _over(clean, jimg) > 1.0

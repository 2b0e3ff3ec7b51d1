"""The port's exact footprint projector (ipdm_tpu_torch/recon/projector.py)
and area LUT (recon/geometry.py) against the JAX package's on the small
fan-beam geometry of tests/test_recon.py (64², 128 detectors, 180 views).
Numeric checks use 1e-5·max|ref| + 1e-4·|ref| (f32 trigonometry of two
libraries); each stands beside a planted fault that has to miss it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.recon import geometry as JG
from ipdm_tpu.recon import projector as JP
from ipdm_tpu_torch.recon import geometry as G
from ipdm_tpu_torch.recon import projector as P

SMALL_KW = dict(nx=64, ny=64, dx=42.0 / 64, dy=42.0 / 64, nr=128,
                dr=0.0010125 * 912 / 128, na=180, ta_dimx=401, ta_dimy=91)
JSMALL = JG.FanBeamGeometry(**SMALL_KW)
SMALL = G.FanBeamGeometry(**SMALL_KW)
LUT = G.area_lut(SMALL)
XY = P.pixel_centers(SMALL).reshape(-1, 2)
ANGLES = (0.0, 33.0, 45.0, 90.0, 271.0)


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


def _feet(angle):
    jf = JP.footprint_for_angle(JSMALL, jnp.asarray(LUT), jnp.asarray(XY),
                                jnp.float32(angle))
    tf = P.footprint_for_angle(SMALL, torch.from_numpy(LUT),
                               torch.from_numpy(XY), torch.tensor(angle))
    return jf, tf


def _drop_last_bin(foot):
    """The planted fault: every pixel's last footprint bin dropped."""
    areas = foot.areas.clone()
    areas[..., -1] = 0
    return foot._replace(areas=areas)


@pytest.mark.parametrize("geom,jgeom", [(SMALL, JSMALL),
                                        (G.SIEMENS, JG.SIEMENS)],
                         ids=["small", "siemens"])
def test_area_lut_and_betas_bit_equal(geom, jgeom):
    lut = G.area_lut(geom)
    assert lut.dtype == np.float32 and lut.shape == (geom.ta_dimy,
                                                     geom.ta_dimx)
    np.testing.assert_array_equal(lut, JG.area_lut(jgeom))
    np.testing.assert_array_equal(G.default_betas(geom),
                                  JG.default_betas(jgeom))
    for name in ("ta_dx", "ta_dy", "vox_base", "xx", "yy", "rr"):
        assert getattr(geom, name) == getattr(jgeom, name)


def test_load_area_lut_reads_the_reference_format(tmp_path):
    path = tmp_path / "alut.bin"
    LUT.tofile(path)
    np.testing.assert_array_equal(G.load_area_lut(str(path), SMALL),
                                  JG.load_area_lut(str(path), JSMALL))


@pytest.mark.parametrize("angle", ANGLES)
def test_footprint_matches_jax(angle):
    """div and s_bin equal; the areas within the rule, and a footprint
    with its last bin dropped misses it."""
    jf, tf = _feet(angle)
    assert tf.s_bin.dtype == torch.int64
    np.testing.assert_array_equal(tf.div.numpy(), np.asarray(jf.div))
    np.testing.assert_array_equal(tf.s_bin.numpy(), np.asarray(jf.s_bin))
    assert _over(tf.areas, jf.areas) <= 1.0
    assert _over(_drop_last_bin(tf).areas, jf.areas) > 1.0
    # line tables and the fold
    beta = (angle - SMALL.angle_start) * np.pi / 180
    ja, jabc = JP.line_params(JSMALL, jnp.float32(beta))
    ta, tabc = P.line_params(SMALL, torch.tensor(beta, dtype=torch.float32))
    assert _over(ta, ja) <= 1.0 and _over(tabc, jabc) <= 1.0


@pytest.mark.parametrize("angle", ANGLES)
def test_fp_bp_and_norms_match_jax(angle):
    rng = np.random.default_rng(int(angle))
    x = rng.random(SMALL.nx * SMALL.ny).astype(np.float32)
    y = rng.standard_normal(SMALL.nr).astype(np.float32)
    jf, tf = _feet(angle)
    pairs = [
        (P.fp_one_angle(torch.from_numpy(x), tf, SMALL),
         JP.fp_one_angle(jnp.asarray(x), jf, JSMALL),
         P.fp_one_angle(torch.from_numpy(x), _drop_last_bin(tf), SMALL)),
        (P.bp_one_angle(torch.from_numpy(y), tf, SMALL),
         JP.bp_one_angle(jnp.asarray(y), jf, JSMALL),
         P.bp_one_angle(torch.from_numpy(y), _drop_last_bin(tf), SMALL)),
        (P.fp_norm_one_angle(tf, SMALL), JP.fp_norm_one_angle(jf, JSMALL),
         P.fp_norm_one_angle(_drop_last_bin(tf), SMALL)),
        (P.bp_norm_one_angle(tf, SMALL), JP.bp_norm_one_angle(jf, JSMALL),
         P.bp_norm_one_angle(_drop_last_bin(tf), SMALL)),
    ]
    for got, want, planted in pairs:
        assert got.shape == want.shape
        assert _over(got, want) <= 1.0
        assert _over(planted, want) > 1.0


def test_block_of_views_equals_one_view_at_a_time():
    """A [V, P] footprint and a batch of images give each view's and each
    image's one-view result."""
    betas = torch.tensor([3.0, 120.0, 250.0])
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((2, SMALL.nx * SMALL.ny), np.float32))
    corr = torch.from_numpy(rng.standard_normal((2, 3, SMALL.nr),
                                                np.float32))
    lut, xy = torch.from_numpy(LUT), torch.from_numpy(XY)
    block = P.footprint_for_angle(SMALL, lut, xy, betas)
    fp = P.fp_one_angle(x, block, SMALL)
    bp = P.bp_one_angle(corr, block, SMALL)
    assert fp.shape == (2, 3, SMALL.nr) and bp.shape == (2, 3, 4096)
    for v in range(3):
        one = P.footprint_for_angle(SMALL, lut, xy, betas[v])
        for b in range(2):
            torch.testing.assert_close(fp[b, v],
                                       P.fp_one_angle(x[b], one, SMALL))
            torch.testing.assert_close(bp[b, v],
                                       P.bp_one_angle(corr[b, v], one, SMALL))


def test_forward_project_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.random((2, SMALL.ny, SMALL.nx)).astype(np.float32)
    betas = G.default_betas(SMALL)
    want = np.stack([np.asarray(JP.forward_project(
        jnp.asarray(xi), JSMALL, jnp.asarray(LUT), jnp.asarray(betas)))
        for xi in x])
    got = P.forward_project_batch(torch.from_numpy(x), SMALL, LUT, betas)
    assert got.shape == (2, SMALL.na, SMALL.nr)
    assert _over(got, want) <= 1.0
    one = P.forward_project(torch.from_numpy(x[1]), SMALL, LUT, betas,
                            block=7)
    assert _over(one, want[1]) <= 1.0
    # planted: one view of one sinogram lost
    planted = got.clone()
    planted[0, 17] = 0
    assert _over(planted, want) > 1.0


@pytest.mark.parametrize("angle", (77.0, 200.0))
def test_port_pair_is_adjoint(angle):
    """⟨FP x, y⟩ = (1/dr)·⟨x, BP y⟩ (FP carries the geodiv factor), rtol
    1e-4; with one footprint bin dropped from the BP only, it misses."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random(SMALL.ny * SMALL.nx).astype(np.float32))
    y = torch.from_numpy(rng.random(SMALL.nr).astype(np.float32))
    _, foot = _feet(angle)
    lhs = float(torch.dot(P.fp_one_angle(x, foot, SMALL).double(),
                          y.double()))

    def rhs(f):
        return float(torch.dot(x.double(), P.bp_one_angle(
            y, f, SMALL).double())) / SMALL.dr

    np.testing.assert_allclose(lhs, rhs(foot), rtol=1e-4)
    areas = foot.areas.clone()
    areas[:, 2] = 0
    assert abs(lhs - rhs(foot._replace(areas=areas))) > 1e-4 * abs(lhs)

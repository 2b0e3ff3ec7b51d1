"""The CPU half of the port's native bindings (ipdm_tpu_torch/utils/
native.py over native/libipdm_native.so): .npy reading, and the C++
footprint projector pair, area LUT and OS-SART held to the port's exact
physics (recon/projector.py, recon/sart.py) at a small geometry, as
tests/test_native.py holds the library to JAX's. Skipped where the
library is not built (``make -C native``)."""

import numpy as np
import pytest
import torch

from ipdm_tpu_torch.recon import geometry as G
from ipdm_tpu_torch.recon import projector as P
from ipdm_tpu_torch.recon.phantom import shepp_logan
from ipdm_tpu_torch.recon.sart import sart_reconstruct
from ipdm_tpu_torch.utils import native

SMALL = G.FanBeamGeometry(nx=32, ny=32, dx=42 / 32, dy=42 / 32, nr=64,
                          dr=0.0010125 * 912 / 64, na=60, ta_dimx=201,
                          ta_dimy=91)


@pytest.fixture(autouse=True)
def _library():
    if not native.available():
        pytest.skip("libipdm_native.so not built (make -C native)")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    lut = G.area_lut(SMALL)
    betas = G.default_betas(SMALL)
    x = shepp_logan(SMALL.nx).astype(np.float32)
    return lut, betas, x


def _scaled_close(got, want, atol):
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def test_npy_read_dtypes_and_order(tmp_path):
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4),
                np.arange(12, dtype=np.float64).reshape(3, 4) * 0.5,
                np.arange(12, dtype=np.int16).reshape(3, 4),
                np.arange(12, dtype=np.uint16).reshape(3, 4),
                np.asfortranarray(np.arange(12, dtype=np.float32)
                                  .reshape(3, 4))):
        p = tmp_path / "a.npy"
        np.save(p, arr)
        got = native.npy_read(str(p), arr.shape)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, arr.astype(np.float32))
    with pytest.raises(IOError):
        native.npy_read(str(tmp_path / "missing.npy"), (3, 4))


def test_native_lut_matches_port():
    np.testing.assert_allclose(native.area_lut_native(SMALL),
                               G.area_lut(SMALL), atol=1e-6)


def test_native_fp_matches_port(small):
    """The library's FP == the port's forward_project (2e-4 of the max,
    tests/test_native.py's bound against JAX)."""
    lut, betas, x = small
    want = P.forward_project(torch.from_numpy(x), SMALL, lut, betas).numpy()
    got = native.fp_project_native(x, SMALL, lut, betas)
    assert got.shape == (SMALL.na, SMALL.nr)
    _scaled_close(got, want, 2e-4)


def test_native_bp_matches_port(small):
    """The library's BP (the transpose of its FP) == the port's
    bp_one_angle summed over the views (clamp addressing, area/div
    weights), and ⟨FP x, y⟩ == (1/dr)·⟨x, BP y⟩ for the library."""
    lut, betas, x = small
    y = np.random.default_rng(0).random((SMALL.na, SMALL.nr), np.float32)
    xy = torch.from_numpy(P.pixel_centers(SMALL).reshape(-1, 2))
    want = torch.zeros(SMALL.ny * SMALL.nx)
    for v0 in range(0, SMALL.na, 20):
        foot = P.footprint_for_angle(SMALL, torch.from_numpy(lut), xy,
                                     torch.from_numpy(betas[v0:v0 + 20]))
        want += P.bp_one_angle(torch.from_numpy(y[v0:v0 + 20]), foot,
                               SMALL).sum(0)
    got = native.bp_project_native(y, SMALL, lut, betas)
    assert got.shape == (SMALL.ny, SMALL.nx)
    _scaled_close(got, want.reshape(SMALL.ny, SMALL.nx).numpy(), 2e-4)
    fp = native.fp_project_native(x, SMALL, lut, betas)
    lhs = float((fp.astype(np.float64) * y).sum())
    rhs = float((x.astype(np.float64) * got).sum()) / SMALL.dr
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_native_sart_matches_port(small):
    """The library's OS-SART == the port's sart_reconstruct (2 sweeps of
    10 subsets; 3e-3 of the max, tests/test_native.py's bound)."""
    lut, betas, x = small
    proj = P.forward_project(torch.from_numpy(x * 0.03), SMALL, lut,
                             betas).numpy()
    want = sart_reconstruct(torch.from_numpy(proj), SMALL,
                            torch.from_numpy(lut), torch.from_numpy(betas),
                            nstart=2, ntv=0, nsubsets=10).numpy()
    got = native.sart_reconstruct_native(proj, SMALL, lut, betas, nstart=2,
                                         ntv=0, nsubsets=10)
    assert got.shape == (SMALL.ny, SMALL.nx)
    _scaled_close(got, want, 3e-3)


def test_native_checks_shapes(small):
    lut, betas, x = small
    with pytest.raises(ValueError, match="betas_deg"):
        native.fp_project_native(x, SMALL, lut, betas[:-1])
    with pytest.raises(ValueError, match="proj"):
        native.bp_project_native(x, SMALL, lut, betas)

"""The port's fast FBP and sharpen against the JAX package's
(ipdm_tpu/recon/fbp_fast.py, ipdm_tpu/ops/sharpen.py) on the small
geometry of tests/test_fbp_fast.py. Off the TPU the JAX converter takes
its gather path; the port's takes the plain BP on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.ops.sharpen import tensor_sharpen as jax_sharpen
from ipdm_tpu.recon.fbp import FBPGeometry as JaxGeometry
from ipdm_tpu.recon.fbp_fast import fbp_convert_fast as jax_fbp
from ipdm_tpu_torch.ops.sharpen import tensor_sharpen
from ipdm_tpu_torch.recon.convertor import Convertor
from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry
from ipdm_tpu_torch.recon.fbp_fast import (_plan_for, _prep_group,
                                           fbp_convert_fast)

SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)


def test_fbp_convert_fast_matches_jax():
    pj = np.random.default_rng(0).random((2, 360, 128)).astype(np.float32)
    want = np.asarray(jax_fbp(jnp.asarray(pj), JaxGeometry(**SMALL)))
    got = fbp_convert_fast(torch.from_numpy(pj), FBPGeometry(**SMALL))
    assert got.shape == (2, 64, 64) and got.dtype == torch.float32
    # f32 FFT ramp and view sums in another order: relative to the image
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)
    via = Convertor("FBP", FBPGeometry(**SMALL))(torch.from_numpy(pj))
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def test_siemens_windows_stay_inside_the_fine_signal():
    """At SIEMENS_FBP the two view groups cover the 1000 folded views and
    every BP window start s satisfies 0 <= s and s + n <= Lq·Kq (the bound
    the BP wrapper checks)."""
    p = _plan_for(SIEMENS_FBP)
    xdm = p.group_xdrive[:SIEMENS_FBP.M // 2]
    Pf = torch.zeros((1, SIEMENS_FBP.M // 2, p.Nt))
    n_views = 0
    for idx, xdrive in ((np.nonzero(xdm)[0], True),
                        (np.nonzero(~xdm)[0], False)):
        T2, s0, s1, fr = _prep_group(Pf, p, idx, xdrive)
        assert T2.shape == (len(idx), 1, p.Lq * p.Kq)
        for s in (s0, s1):
            assert int(s.min()) >= 0 and int(s.max()) + p.n <= p.Lq * p.Kq
        assert float(fr.min()) >= 0.0 and float(fr.max()) < 1.0
        n_views += len(idx)
    assert n_views == 1000


@pytest.mark.parametrize("N", [70, 42, -1])
def test_tensor_sharpen_matches_jax(N):
    img = np.random.default_rng(N + 100).random((2, 20, 24, 3)).astype(
        np.float32)
    want = np.asarray(jax_sharpen(jnp.asarray(img), N))
    got = tensor_sharpen(torch.from_numpy(img), N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

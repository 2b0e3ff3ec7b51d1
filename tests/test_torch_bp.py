"""The port's batched shifted-window backprojection (plain PyTorch version)
against the JAX Pallas kernel ipdm_tpu/ops/pallas/shift.py:
bp_shift_accumulate_batched in interpret mode (the shapes of
tests/test_fbp_fast.py:69-90). The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.ops.pallas.shift import bp_shift_accumulate_batched as jax_bp
from ipdm_tpu_torch.ops.cuda import _build
from ipdm_tpu_torch.ops.cuda.shift import (bp_shift_accumulate_batched,
                                           bp_shift_accumulate_plain)


def _inputs(V, B, L, n, seed=0):
    rng = np.random.RandomState(seed)
    Q = rng.rand(V, B, L).astype(np.float32)
    # the TPU kernel needs its windows within L - n - 128
    s0 = rng.randint(0, L - n - 128, (V, n)).astype(np.int32)
    s1 = np.minimum(s0 + 1, L - n - 128).astype(np.int32)
    fr = rng.rand(V, n).astype(np.float32)
    return Q, s0, s1, fr


# V = 13 is not a multiple of the TPU kernel's 8-view blocks
@pytest.mark.parametrize("V", [16, 13])
def test_bp_plain_matches_pallas(V):
    B, L, n = 3, 512, 128
    Q, s0, s1, fr = _inputs(V, B, L, n)
    want = np.asarray(jax_bp(jnp.asarray(Q), jnp.asarray(s0),
                             jnp.asarray(s1), jnp.asarray(fr), n,
                             interpret=True))
    t = torch.from_numpy
    got = bp_shift_accumulate_plain(t(Q), t(s0), t(s1), t(fr), n)
    # f32 sums of V products in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    before = _build.LAUNCHES["bp_shift"]
    via_wrapper = bp_shift_accumulate_batched(t(Q), t(s0), t(s1), t(fr), n)
    torch.testing.assert_close(via_wrapper, got, rtol=0, atol=0)
    assert _build.LAUNCHES["bp_shift"] == before


def test_bp_rejects_windows_past_the_signal():
    """JAX clamps out-of-range gather indices silently; the port checks
    s + n <= L instead of reading past the signal."""
    V, B, L, n = 8, 2, 256, 64
    Q, s0, s1, fr = (torch.from_numpy(a) for a in _inputs(V, B, L, n))
    s1 = s1.clone()
    s1[3, 5] = L - n + 1
    with pytest.raises(ValueError, match="window"):
        bp_shift_accumulate_batched(Q, s0, s1, fr, n)
    s0 = s0.clone()
    s0[0, 0] = -1
    with pytest.raises(ValueError, match="window"):
        bp_shift_accumulate_batched(Q, s0, s1, fr, n)


@pytest.mark.parametrize("geom", ["siemens", "small"])
def test_fbp_start_bounds_cover_its_starts(geom):
    """The fast FBP hands the BP wrappers a (low, high) of its starts
    computed on the host from the clamp that makes them, in place of a
    device read: every start of both view groups lies inside it, and the
    windows it allows stay inside the signal."""
    from ipdm_tpu_torch.recon import fbp_fast
    from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry

    g = SIEMENS_FBP if geom == "siemens" else FBPGeometry(
        n_det=128, n_views=360, grid_n=64, grid_l=21.0,
        da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)
    p = fbp_fast._plan_for(g)
    lo, hi = fbp_fast._start_bounds(p)
    assert lo == 0 and hi + p.n <= p.Lq * p.Kq
    M = g.M // 2 if g.M % 2 == 0 else g.M
    Pf = torch.rand((1, M, p.Nt))
    xdm = p.group_xdrive[:M]
    for xdrive in (True, False):
        ids = np.nonzero(xdm if xdrive else ~xdm)[0]
        T2, s0, s1, _ = fbp_fast._prep_group(Pf, p, ids, xdrive)
        assert T2.shape[2] == p.Lq * p.Kq
        for s in (s0, s1):
            assert int(s.min()) >= lo and int(s.max()) <= hi

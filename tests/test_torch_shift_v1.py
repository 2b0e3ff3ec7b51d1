"""The plain PyTorch versions of the port's single-signal BP
(bp_shift_accumulate), its two shift deposits (fp_shift_deposit_batched,
fp_shift_deposit) and the bf16 operand mode of os_sart_sweep against the
JAX Pallas kernels in interpret mode, with the tables of
tests/test_fbp_fast.py (BP) and tests/test_sart_fast.py (deposit, sweep).
On CPU tensors the wrappers run the plain versions and count no launch;
the CUDA kernels are held against the plain versions on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.ops.pallas import shift as jax_shift
from ipdm_tpu.recon import sart_fast as jax_sf
from ipdm_tpu.recon.fbp import FBPGeometry as JaxGeometry
from ipdm_tpu_torch.ops.cuda import _build, shift
from ipdm_tpu_torch.recon import sart_fast
from ipdm_tpu_torch.recon.fbp import FBPGeometry

t = torch.from_numpy
j = jnp.asarray


def _via_wrapper(name, fn, *args, **kw):
    """fn on CPU tensors, with no launch counted."""
    before = dict(_build.LAUNCHES)
    out = fn(*args, **kw)
    assert _build.LAUNCHES == before
    return out


def _bp_inputs():
    rng = np.random.RandomState(0)
    V, B, L, n = 16, 3, 512, 128
    Q = rng.rand(V, B, L).astype(np.float32)
    s0 = rng.randint(0, L - n - 128, (V, n)).astype(np.int32)
    s1 = np.minimum(s0 + 1, L - n - 128).astype(np.int32)
    fr = rng.rand(V, n).astype(np.float32)
    return Q, s0, s1, fr, n


def test_bp_shift_accumulate_plain_matches_pallas():
    Q, s0, s1, fr, n = _bp_inputs()
    for b in range(Q.shape[1]):
        Q2 = np.ascontiguousarray(Q[:, b])
        want = np.asarray(jax_shift.bp_shift_accumulate(
            j(Q2), j(s0), j(s1), j(fr), n, interpret=True))
        got = _via_wrapper("bp_shift_accumulate", shift.bp_shift_accumulate,
                           t(Q2), t(s0), t(s1), t(fr), n)
        assert got.shape == (n, n)
        # f32 sums over 16 views in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        batched = shift.bp_shift_accumulate_batched(t(Q), t(s0), t(s1),
                                                    t(fr), n)[b]
        torch.testing.assert_close(got, batched, rtol=0, atol=0)


def test_bp_shift_accumulate_takes_any_view_count():
    """The TPU kernel needs a multiple of 8 views; the port does not."""
    Q, s0, s1, fr, n = _bp_inputs()
    got = shift.bp_shift_accumulate(t(Q[:5, 0].copy()), t(s0[:5]), t(s1[:5]),
                                    t(fr[:5]), n)
    pad = lambda a: np.concatenate([a[:5], np.zeros_like(a[:3])])
    want = np.asarray(jax_shift.bp_shift_accumulate(
        j(pad(Q[:, 0])), j(pad(s0)), j(pad(s1)), j(pad(fr)), n,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _deposit_inputs():
    rng = np.random.RandomState(1)
    n, B, W, V, L = 32, 2, 128, 16, 768
    rows = rng.rand(n, B, W).astype(np.float32)
    s0 = rng.randint(0, L - W - 128, (V, n)).astype(np.int32)
    s1 = np.minimum(s0 + 1, L - W - 129).astype(np.int32)
    w0 = rng.rand(V, n).astype(np.float32)
    w1 = rng.rand(V, n).astype(np.float32)
    return rows, s0, s1, w0, w1, L


def test_fp_shift_deposit_batched_plain_matches_pallas():
    rows, s0, s1, w0, w1, L = _deposit_inputs()
    want = np.asarray(jax_shift.fp_shift_deposit_batched(
        j(rows), j(s0), j(s1), j(w0), j(w1), L, interpret=True))
    args = (t(rows), t(s0), t(s1), t(w0), t(w1), L)
    got = _via_wrapper("fp_shift_deposit_batched",
                       shift.fp_shift_deposit_batched, *args)
    assert got.shape == (16, 2, L)
    # f32 sums of up to 64 deposits per bin in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, shift.fp_plane_deposit(*args), rtol=0,
                               atol=0)


def test_fp_shift_deposit_plain_matches_pallas():
    rows, s0, s1, w0, w1, L = _deposit_inputs()
    for b in range(rows.shape[1]):
        r2 = np.ascontiguousarray(rows[:, b])
        want = np.asarray(jax_shift.fp_shift_deposit(
            j(r2), j(s0), j(s1), j(w0), j(w1), L, interpret=True))
        got = _via_wrapper("fp_shift_deposit", shift.fp_shift_deposit,
                           t(r2), t(s0), t(s1), t(w0), t(w1), L)
        assert got.shape == (16, L)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        plain = shift.fp_shift_deposit_plain(t(r2), t(s0), t(s1), t(w0),
                                             t(w1), L)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_shift_deposits_take_unaligned_widths():
    """The TPU kernels need W and L in multiples of 128 and starts below
    L − W − 128; the port needs only 0 ≤ s and s + W ≤ L."""
    rng = np.random.RandomState(2)
    n, B, W, V, L = 10, 2, 37, 3, 90
    rows = rng.rand(n, B, W).astype(np.float32)
    s0 = rng.randint(0, L - W + 1, (V, n)).astype(np.int32)
    s0[0, 0], s0[1, 1] = 0, L - W       # both ends of the legal range
    s1 = np.minimum(s0 + 1, L - W).astype(np.int32)
    w0 = rng.rand(V, n).astype(np.float32)
    w1 = rng.rand(V, n).astype(np.float32)
    want = np.zeros((V, B, L), np.float32)
    for v in range(V):
        for y in range(n):
            want[v, :, s0[v, y]:s0[v, y] + W] += w0[v, y] * rows[y]
            want[v, :, s1[v, y]:s1[v, y] + W] += w1[v, y] * rows[y]
    got = shift.fp_shift_deposit_batched(t(rows), t(s0), t(s1), t(w0),
                                         t(w1), L)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    one = shift.fp_shift_deposit(t(rows[:, 1].copy()), t(s0), t(s1), t(w0),
                                 t(w1), L)
    np.testing.assert_allclose(one.numpy(), want[:, 1], rtol=1e-5, atol=1e-5)


def _sweep_inputs():
    rng = np.random.RandomState(0)
    S, Vp, B, n, L = 3, 8, 2, 64, 512
    x0 = rng.rand(B, n, n).astype(np.float32)
    rf = rng.rand(S, Vp, B, L).astype(np.float32)
    inv2 = rng.rand(S, Vp, L).astype(np.float32)
    s0 = np.zeros((S, Vp, n), np.int32)
    frac = rng.rand(S, Vp, n).astype(np.float32)
    for s in range(S):
        for v in range(Vp):
            start = rng.randint(0, L - n - 130)
            sgn = 1 if rng.rand() > 0.5 else -1
            steps = (rng.rand(n - 1) < rng.rand()).astype(np.int64) * sgn
            seq = np.clip(start + np.concatenate([[0], np.cumsum(steps)]),
                          0, L - n - 130)
            s0[s, v] = seq
    nrmi = rng.rand(S, n, n).astype(np.float32)
    return x0, rf, inv2, frac, s0, nrmi


def test_os_sart_sweep_bf16_plain_matches_pallas():
    x0, rf, inv2, frac, s0, nrmi = _sweep_inputs()
    lam = 0.3
    jargs = (j(x0), j(rf), j(inv2), j(frac), j(s0), j(nrmi),
             jnp.float32(lam))
    want = np.asarray(jax_shift.os_sart_sweep_mm(*jargs, interpret=True,
                                                 G=4, bf16=True))
    f32 = np.asarray(jax_shift.os_sart_sweep_mm(*jargs, interpret=True,
                                                G=4))
    args = (t(x0), t(rf), t(inv2), t(frac), t(s0), t(nrmi), lam)
    got = _via_wrapper("os_sart_sweep_bf16", shift.os_sart_sweep, *args,
                       bf16=True)
    # the same bf16-rounded operands on both sides, exact products, f32
    # sums in another order: the f32 mode's tolerance, which is far below
    # the distance between the two modes
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    gap = float(np.abs(want - f32).max())
    assert gap > 50 * float(np.abs(got.numpy() - want).max()), gap
    plain = shift.os_sart_sweep_plain(*args, bf16=True)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)


def test_sart_fast_convert_mm_bf16_matches_jax():
    pj = np.random.default_rng(0).random((2, 360, 128)).astype(np.float32)
    kw = dict(nstart=2, ntv=0, nsubsets=6)
    want = np.asarray(jax_sf.sart_fast_convert(
        j(pj), JaxGeometry(**SMALL), mm_bf16=True, **kw))
    f32 = np.asarray(jax_sf.sart_fast_convert(j(pj), JaxGeometry(**SMALL),
                                              **kw))
    got = sart_fast.sart_fast_convert(t(pj), FBPGeometry(**SMALL),
                                      mm_bf16=True, **kw).numpy()
    # a last-bit difference of an f32 value can move its bf16 rounding by
    # one bf16 step (2^-8 relative), so the two sides agree to a few
    # bf16 steps' effect on a sum, not to f32: 2e-3 of the image's range
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * scale)
    assert float(np.abs(want - f32).max()) > float(np.abs(got - want).max())


@pytest.mark.parametrize("kernel", ["bp", "deposit-batched", "deposit",
                                    "bp-shape", "deposit-shape"])
def test_new_wrappers_check_windows_and_shapes(kernel):
    Q, s0, s1, fr, n = _bp_inputs()
    rows, d0, d1, w0, w1, L = _deposit_inputs()
    if kernel == "bp":
        s1[3, 3] = Q.shape[2] - n + 1
        call = lambda: shift.bp_shift_accumulate(t(Q[:, 0].copy()), t(s0),
                                                 t(s1), t(fr), n)
    elif kernel == "deposit-batched":
        d0[0, 0] = L - rows.shape[2] + 1
        call = lambda: shift.fp_shift_deposit_batched(
            t(rows), t(d0), t(d1), t(w0), t(w1), L)
    elif kernel == "deposit":
        d1[2, 1] = -1
        call = lambda: shift.fp_shift_deposit(
            t(rows[:, 0].copy()), t(d0), t(d1), t(w0), t(w1), L)
    elif kernel == "bp-shape":
        call = lambda: shift.bp_shift_accumulate(t(Q), t(s0), t(s1), t(fr),
                                                 n)
    else:
        call = lambda: shift.fp_shift_deposit(t(rows), t(d0), t(d1), t(w0),
                                              t(w1), L)
    with pytest.raises(ValueError, match="window|must be"):
        call()

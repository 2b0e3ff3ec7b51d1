"""The plain PyTorch versions of the port's SART kernels against the JAX
Pallas kernels in interpret mode, at the oracle sizes of
tests/test_sart_fast.py: anterp_taps (:110), os_sart_sweep_mm (:138) and
fp_plane_deposit (:209), with the tables built the same way. On CPU
tensors the wrappers run the plain versions and count no launch; the CUDA
kernels are held against the plain versions on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.ops.pallas import shift as jax_shift
from ipdm_tpu_torch.ops.cuda import _build
from ipdm_tpu_torch.ops.cuda import shift

t = torch.from_numpy


def _via_wrapper(name, fn, *args):
    """fn on CPU tensors, with no launch counted."""
    before = _build.LAUNCHES[name]
    out = fn(*args)
    assert _build.LAUNCHES[name] == before
    return out


def _anterp_inputs():
    rng = np.random.RandomState(3)
    V, B, Wt, Lp, M = 6, 2, 4, 256, 640
    P = rng.rand(V, B, M + jax_shift._WTR_WIN).astype(np.float32)
    P[:, :, M:] = 0.0
    qi0 = np.zeros((V, Lp), np.int32)
    for v in range(V):
        step = rng.uniform(0.9, 1.4)
        base = rng.randint(0, 40)
        seq = np.clip((base + np.arange(Lp) * step).astype(np.int64),
                      0, M - 1)
        qi0[v] = seq[::-1] if v % 2 else seq  # either monotone direction
    W = rng.rand(V, Wt, Lp).astype(np.float32)
    return P, qi0, W


def test_anterp_taps_plain_matches_pallas():
    P, qi0, W = _anterp_inputs()
    want = np.asarray(jax_shift.anterp_taps(
        jnp.asarray(P), jnp.asarray(qi0), jnp.asarray(W), interpret=True))
    got = shift.anterp_taps_plain(t(P), t(qi0), t(W))
    # f32 sums of 4 products in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    via = _via_wrapper("anterp_taps", shift.anterp_taps, t(P), t(qi0), t(W))
    torch.testing.assert_close(via, got, rtol=0, atol=0)


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


def test_os_sart_sweep_plain_matches_pallas():
    x0, rf, inv2, frac, s0, nrmi = _sweep_inputs()
    lam = 0.3
    want = np.asarray(jax_shift.os_sart_sweep_mm(
        jnp.asarray(x0), jnp.asarray(rf), jnp.asarray(inv2),
        jnp.asarray(frac), jnp.asarray(s0), jnp.asarray(nrmi),
        jnp.float32(lam), interpret=True, G=4))
    args = (t(x0), t(rf), t(inv2), t(frac), t(s0), t(nrmi), lam)
    got = shift.os_sart_sweep_plain(*args)
    # 3 subsets of f32 FP/BP sums over 64 rows and 8 views, in another
    # order (the JAX kernel's own oracle test allows 2e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    via = _via_wrapper("os_sart_sweep", shift.os_sart_sweep, *args)
    torch.testing.assert_close(via, got, rtol=0, atol=0)
    # with the FP tiles' row ranges the CUDA kernel takes (checked, then
    # not needed by the plain version)
    rows = shift.sweep_row_ranges(args[4], x0.shape[2], rf.shape[3])
    via = _via_wrapper("os_sart_sweep", lambda *a: shift.os_sart_sweep(
        *a, row_ranges=rows), *args)
    torch.testing.assert_close(via, got, rtol=0, atol=0)
    np.testing.assert_array_equal(args[0].numpy(), x0)  # x is not changed


def _deposit_inputs():
    rng = np.random.RandomState(1)
    n, B, W, V, L = 32, 2, 128, 16, 768
    rows = rng.rand(n, B, W).astype(np.float32)
    s0 = rng.randint(0, L - W - 128, (V, n)).astype(np.int32)
    s1 = np.minimum(s0 + 1, L - W - 129).astype(np.int32)
    w0 = rng.rand(V, n).astype(np.float32)
    w1 = rng.rand(V, n).astype(np.float32)
    return rows, s0, s1, w0, w1, L


def test_fp_plane_deposit_plain_matches_pallas():
    rows, s0, s1, w0, w1, L = _deposit_inputs()
    want = np.asarray(jax_shift.fp_plane_deposit(
        jnp.asarray(rows), jnp.asarray(s0), jnp.asarray(s1),
        jnp.asarray(w0), jnp.asarray(w1), L, interpret=True))
    args = (t(rows), t(s0), t(s1), t(w0), t(w1), L)
    got = shift.fp_plane_deposit_plain(*args)
    # f32 sums of up to 64 deposits per bin in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    via = _via_wrapper("fp_plane_deposit", shift.fp_plane_deposit, *args)
    torch.testing.assert_close(via, got, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["anterp", "sweep", "deposit",
                                    "anterp-bounds", "sweep-bounds",
                                    "deposit-bounds", "shift-deposit",
                                    "shift-deposit-bounds",
                                    "batched-deposit-bounds"])
def test_wrappers_reject_windows_past_the_signal(kernel):
    """JAX clamps out-of-range indices silently; each wrapper checks its
    windows on the host instead of reading or writing past the signal,
    on the starts themselves or on the (min, max) a caller passes for a
    static table (the deposits' bounds cover both start tables)."""
    if kernel.startswith("anterp"):
        P, qi0, W = _anterp_inputs()
        over = P.shape[2] - W.shape[1] + 1
        if kernel == "anterp":
            qi0[2, 5] = over
            call = lambda: shift.anterp_taps(t(P), t(qi0), t(W))
        else:
            call = lambda: shift.anterp_taps(t(P), t(qi0), t(W),
                                             qi0_bounds=(0, over))
    elif kernel.startswith("sweep"):
        x0, rf, inv2, frac, s0, nrmi = _sweep_inputs()
        over = rf.shape[3] - x0.shape[2]   # the s0 + 1 tap overruns
        bounds = None
        if kernel == "sweep":
            s0[1, 2, 3] = over
        else:
            bounds = (int(s0.min()), over)
        call = lambda: shift.os_sart_sweep(t(x0), t(rf), t(inv2), t(frac),
                                           t(s0), t(nrmi), 0.3,
                                           s0_bounds=bounds)
    else:
        rows, s0, s1, w0, w1, L = _deposit_inputs()
        W = rows.shape[2]
        bounds = None
        if kernel.endswith("-bounds"):   # the tables fit, the bounds don't
            bounds = (0, L - W + 1)
        elif kernel == "deposit":
            s0[4, 0] = -1
        else:
            s1[2, 7] = L - W + 1
        if kernel.startswith("shift"):
            call = lambda: shift.fp_shift_deposit(
                t(rows[:, 0].copy()), t(s0), t(s1), t(w0), t(w1), L,
                bounds=bounds)
        elif kernel.startswith("batched"):
            call = lambda: shift.fp_shift_deposit_batched(
                t(rows), t(s0), t(s1), t(w0), t(w1), L, bounds=bounds)
        else:
            call = lambda: shift.fp_plane_deposit(
                t(rows), t(s0), t(s1), t(w0), t(w1), L, bounds=bounds)
    with pytest.raises(ValueError, match="window"):
        call()

"""The order in which csrc/fp_deposit.cu (the one kernel behind
fp_plane_deposit, fp_shift_deposit_batched and fp_shift_deposit) and
csrc/anterp_taps.cu sum, written out on the CPU, and the host bounds the
plan and projector paths hand the wrappers:

* the deposit in the kernel's order — bands of DEP_BAND rows, tiles of
  DEP_TILE bins that some tap window of the band meets, the band's taps
  that meet the tile in (row, tap) order, the bands' partials added in
  band order — against fp_plane_deposit_plain, on
  monotone tables with s1 = s0 + 1, tables with s1 ≠ s0 + 1 (the fast
  projector's two k-planes), tables that mix both, tables that are not
  monotone, and the 64² plans' own tables: the tiles and bands lose no
  tap, and one row dropped from one band does not pass the same
  tolerance;
* anterp_taps in the kernel's mapping (one output per (view, bin), each
  batch item's taps summed in k order) at Wt = 2, 4 and 6;
* the plan's norms, the OS-SART convert and project_fast pass every
  deposit and anterp wrapper bounds from the host, so no window check
  reads the device.

The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from ipdm_tpu_torch.ops.cuda import shift
from ipdm_tpu_torch.recon import sart_fast
from ipdm_tpu_torch.recon.fbp import FBPGeometry

t = torch.from_numpy
DEP_BAND = 32     # csrc/fp_deposit.cu kBand: rows per band
DEP_TILE = 128    # csrc/fp_deposit.cu kTile: bins per warp tile

SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)


def _band_sum(rows, s0, s1, w0, w1, W, k, drop=None):
    """One band's partial over tile k: rows [R, B, W] (the band's rows),
    s0/s1/w0/w1 [R]. Returns [B, DEP_TILE]."""
    R, B, _ = rows.shape
    tb = k * DEP_TILE + np.arange(DEP_TILE)

    def vals(r, s):                      # rows[r, :, tb - s], 0 off the row
        u = tb - s
        ok = (u >= 0) & (u < W)
        return np.where(ok, rows[r][:, np.clip(u, 0, W - 1)], 0.0)

    meets = lambda s: s // DEP_TILE <= k <= (s + W - 1) // DEP_TILE
    p = np.zeros((B, DEP_TILE), np.float32)
    for r in range(R):
        if r == drop:
            continue
        for s, w in ((s0[r], w0[r]), (s1[r], w1[r])):
            if meets(s):
                p += np.float32(w) * vals(r, s).astype(np.float32)
    return p


def _deposit_kernel_order(rows, s0, s1, w0, w1, L, drop=None):
    """fp_deposit.cu's sum: rows [n, B, W] f32; s0, s1, w0, w1 [V, n];
    ``drop`` = (v, row) leaves one row out of its band. Returns [V, B, L]
    f32."""
    n, B, W = rows.shape
    V = s0.shape[0]
    nt = -(-L // DEP_TILE)
    out = np.zeros((V, B, L), np.float32)
    for v in range(V):
        acc = np.zeros((B, nt * DEP_TILE), np.float32)
        for y0 in range(0, n, DEP_BAND):
            ys = np.arange(y0, min(y0 + DEP_BAND, n))
            cut = None
            if drop is not None and drop[0] == v and drop[1] in ys:
                cut = int(drop[1] - y0)
            lo = min(s0[v, ys].min(), s1[v, ys].min()) // DEP_TILE
            hi = (max(s0[v, ys].max(), s1[v, ys].max()) + W - 1) // DEP_TILE
            for k in range(lo, hi + 1):
                acc[:, k * DEP_TILE:(k + 1) * DEP_TILE] += _band_sum(
                    rows[ys], s0[v, ys], s1[v, ys], w0[v, ys], w1[v, ys], W,
                    k, cut)
        out[v] = acc[:, :L]
    return out


def _monotone(rng, V, n, top):
    """Starts that move by 0 or ±1 per row, one direction per view."""
    s = np.zeros((V, n), np.int64)
    for v in range(V):
        sgn = 1 if rng.random() > 0.5 else -1
        seq = np.concatenate([[0], np.cumsum(
            (rng.random(n - 1) < rng.random()) * sgn)])
        seq -= seq.min()
        s[v] = seq + rng.integers(0, top - int(seq.max()) + 1)
    return s


def _tables(kind):
    """(rows [n, B, W], s0, s1, w0, w1, L) of one kind of deposit."""
    rng = np.random.default_rng(11)
    if kind in ("plan64-sweep", "plan64-projector"):
        g = FBPGeometry(**SMALL)
        sp = (sart_fast._splan_for(g, 6, fold=True, kf=1)
              if kind == "plan64-sweep" else
              sart_fast._splan_for(g, 1, fold=True))
        grp = sp.gx_all
        tb = grp.tables("cpu")
        n = sp.p.n
        rows = rng.random((n, 2, n), np.float32)
        frac = tb["frac"].numpy()
        return (rows, tb["s0"].numpy().astype(np.int64),
                tb["s1"].numpy().astype(np.int64),
                (1 - frac).astype(np.float32), frac.astype(np.float32),
                grp.L)
    V, n, B, W, L = 5, 40, 2, 48, 300
    rows = rng.random((n, B, W), np.float32)
    w0 = rng.random((V, n), np.float32)
    w1 = rng.random((V, n), np.float32)
    if kind == "monotone":
        s0 = _monotone(rng, V, n, L - W - 1)
        s1 = s0 + 1
    elif kind == "planes":           # the two taps in two k-planes
        m = _monotone(rng, V, n, 2 * (L // 2 - W) - 2)
        plane = lambda q: (q % 2) * (L // 2) + q // 2
        s0, s1 = plane(m), plane(m + 1)
    elif kind == "mixed":            # a few rows with s1 = s0 (a clamp)
        s0 = _monotone(rng, V, n, L - W - 1)
        s1 = s0 + (rng.random((V, n)) > 0.1)
    else:                            # not monotone, free s1
        s0 = rng.integers(0, L - W + 1, (V, n))
        s1 = rng.integers(0, L - W + 1, (V, n))
    return rows, s0, s1, w0, w1, L


def _plain(rows, s0, s1, w0, w1, L):
    return shift.fp_plane_deposit_plain(
        t(rows), t(s0.astype(np.int32)), t(s1.astype(np.int32)), t(w0),
        t(w1), L).numpy()


def _bound(rows, s0, s1, w0, w1, L):
    """chip_smoke.py's f32 bound of two summation orders of 2n terms."""
    absum = _plain(np.abs(rows), s0, s1, np.abs(w0), np.abs(w1), L)
    return 2 * (2 * rows.shape[0]) * 2.0 ** -24 * absum


KINDS = ["monotone", "planes", "mixed", "nonmonotone", "plan64-sweep",
         "plan64-projector"]


@pytest.mark.parametrize("kind", KINDS)
def test_deposit_in_kernel_order_loses_no_tap(kind):
    args = _tables(kind)
    got = _deposit_kernel_order(*args)
    want = _plain(*args)
    assert np.all(np.abs(got - want) <= _bound(*args))


@pytest.mark.parametrize("kind", ["monotone", "planes"])
def test_deposit_order_sees_a_dropped_row(kind):
    """The planted fault of chip_smoke.py's deposit check, on the CPU: one
    live row left out of one band misses the bound."""
    args = _tables(kind)
    rows, s0, s1, w0, w1, L = args
    got = _deposit_kernel_order(*args, drop=(2, 21))
    over = np.abs(got - _plain(*args)) / np.maximum(_bound(*args), 1e-30)
    assert over.max() > 1.0


def _anterp_kernel_order(P, qi0, W):
    """anterp_taps.cu: per (v, d) the Wt weights once, then per item the
    taps summed in k order from 0."""
    V, B, _ = P.shape
    Wt, Lp = W.shape[1], W.shape[2]
    out = np.zeros((V, B, Lp), np.float32)
    for v in range(V):
        idx = qi0[v][None, :] + np.arange(Wt)[:, None]      # [Wt, Lp]
        for b in range(B):
            acc = np.zeros((Lp,), np.float32)
            for k in range(Wt):
                acc = acc + W[v, k] * P[v, b, idx[k]]
            out[v, b] = acc
    return out


@pytest.mark.parametrize("Wt", [2, 4, 6])
def test_anterp_in_kernel_order(Wt):
    rng = np.random.default_rng(Wt)
    V, B, Lp, Ntp = 4, 3, 200, 170
    P = rng.random((V, B, Ntp), np.float32)
    qi0 = np.stack([np.clip((np.arange(Lp) * rng.uniform(0.5, 0.8)
                             ).astype(np.int64) + rng.integers(0, 9), 0,
                            Ntp - Wt) for _ in range(V)]).astype(np.int32)
    qi0[1] = rng.integers(0, Ntp - Wt + 1, Lp)     # not monotone
    W = rng.random((V, Wt, Lp), np.float32)
    got = _anterp_kernel_order(P, qi0, W)
    want = shift.anterp_taps_plain(t(P), t(qi0), t(W)).numpy()
    absum = shift.anterp_taps_plain(t(P), t(qi0), t(np.abs(W))).numpy()
    assert np.all(np.abs(got - want) <= 2 * Wt * 2.0 ** -24 * absum)


def test_plan_and_projector_pass_host_bounds(monkeypatch):
    """The OS-SART plan's norms, the convert's resample and project_fast
    give every deposit and anterp wrapper a (low, high) from the host, so
    none of their window checks reads the device."""
    seen = []
    real = shift._check_windows

    def spy(s0, s1, n, L, name="bp_shift_accumulate", bounds=None):
        seen.append((name, bounds is not None))
        return real(s0, s1, n, L, name, bounds)

    monkeypatch.setattr(shift, "_check_windows", spy)
    g = FBPGeometry(**SMALL)
    sart_fast._SPLANS.clear()
    vol = torch.rand((2, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        sino = sart_fast.project_fast(vol, g, g.N, float(g.nda[0]),
                                      float(g.da))
        sart_fast.sart_fast_convert(sino[:1], g, nstart=1, nsubsets=6)
    names = {nm for nm, _ in seen}
    assert {"fp_plane_deposit", "fp_shift_deposit_batched",
            "anterp_taps"} <= names, names
    assert all(ok for nm, ok in seen
               if nm.startswith("fp_") or nm == "anterp_taps"), seen

"""The row-range table of the OS-SART sweep's FP tiles
(ipdm_tpu_torch/ops/cuda/shift.py: sweep_row_ranges) and the order in which
csrc/os_sart_sweep.cu sums, written out on the CPU:

* the table against a brute-force scan of every (subset, view, tile), on
  random monotone starts with |Δs| ≤ 1, random starts that are not
  monotone, and the tables of a 64² plan;
* the FP in the kernel's order (a tile's rows from the table only, split
  into one contiguous share per warp, one load per value serving tap 0 of
  its bin and tap 1 of the next, the warps' partials added in warp order)
  against fp_plane_deposit_plain, f32 and bf16 operands, and the BP in the
  shared gather's order (bp_gather.cuh with s1 = s0 + 1) against the
  sweep's plain BP: the tiling and the shifted tap-1 sums lose no tap;
* the wrapper's checks of the table (shape, rows within [0, n]).

The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from ipdm_tpu_torch.ops.cuda import shift
from ipdm_tpu_torch.recon import sart_fast
from ipdm_tpu_torch.recon.fbp import FBPGeometry

t = torch.from_numpy
TILE = shift.SWEEP_TILE
FP_SPLIT = 4      # csrc/os_sart_sweep.cu kFpSplit: blocks per tile
FP_WARPS = 8      # csrc/os_sart_sweep.cu kFpWarps
BP_COLS = 128     # columns per warp of csrc/bp_gather.cuh (32 lanes x 4)

SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)


def _monotone_starts(rng, S, V, n, L):
    """Per (s, v), starts that move by 0 or ±1 per row, one direction per
    view, as the Kf = 1 plans have them."""
    s0 = np.zeros((S, V, n), np.int32)
    for s in range(S):
        for v in range(V):
            sgn = 1 if rng.random() > 0.5 else -1
            steps = (rng.random(n - 1) < rng.random()).astype(np.int64) * sgn
            seq = np.concatenate([[0], np.cumsum(steps)])
            seq -= seq.min()
            top = L - n - 1 - int(seq.max())
            s0[s, v] = seq + rng.integers(0, top + 1)
    return s0


def _tables(kind):
    """(s0 [S, V, n], n, L) of one kind of start table."""
    rng = np.random.default_rng(7)
    if kind == "monotone":
        S, V, n, L = 3, 5, 96, 384
        return _monotone_starts(rng, S, V, n, L), n, L
    if kind == "nonmonotone":
        S, V, n, L = 2, 4, 48, 300
        return rng.integers(0, L - n, (S, V, n)).astype(np.int32), n, L
    sp = sart_fast._splan_for(FBPGeometry(**SMALL), 6, fold=True, kf=1)
    out = []
    for key in ("x", "y"):
        s0, _, _ = sp.fused_tables(key, "cpu")
        out.append((s0.numpy(), sp.p.n, sp.group(key).L))
    assert out[0][1:] == out[1][1:]
    return np.concatenate([o[0] for o in out]), out[0][1], out[0][2]


def _brute_force(s0, n, L):
    S, V, _ = s0.shape
    nt = -(-L // TILE)
    want = np.zeros((S, V, nt, 2), np.int32)
    for s in range(S):
        for v in range(V):
            # every bin each row's two taps land on: [n, n + 1]
            bins = s0[s, v][:, None] + np.arange(n + 1)
            for k in range(nt):
                t0 = k * TILE
                ys = np.flatnonzero(((bins >= t0) & (bins < t0 + TILE))
                                    .any(axis=1))
                if len(ys):
                    want[s, v, k] = (ys[0], ys[-1] + 1)
    return want


@pytest.mark.parametrize("kind", ["monotone", "nonmonotone", "plan64"])
def test_row_ranges_match_brute_force(kind):
    s0, n, L = _tables(kind)
    got = shift.sweep_row_ranges(t(s0), n, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _brute_force(s0, n, L))


def _shares(r0, r1):
    """The (first, end) rows of each warp's share of a tile's range, in
    the order the kernel adds their partials."""
    all_ = max(r1 - r0, 0)
    chunk = -(-all_ // FP_SPLIT)
    for rank in range(FP_SPLIT):
        c0 = r0 + rank * chunk
        cnt = max(min(all_ - rank * chunk, chunk), 0)
        share = -(-cnt // FP_WARPS)
        for w in range(FP_WARPS):
            lo, hi = c0 + w * share, min(c0 + cnt, c0 + (w + 1) * share)
            if lo < hi:
                yield lo, hi


def _fp_kernel_order(x, w0, w1, s0, rows, L):
    """The FP half as the kernel sums it: x [B, n, n], w0/w1/s0 [V, n],
    rows [V, nTiles, 2] → [V, B, L]. A tile's rows split into FP_SPLIT
    chunks (the blocks of a cluster), each chunk into FP_WARPS shares; the
    shares' partials add in warp order, the chunks' in rank order."""
    B, n, _ = x.shape
    V = s0.shape[0]
    out = torch.zeros((V, B, L))
    for v in range(V):
        for k in range(rows.shape[1]):
            t0 = k * TILE
            r0, r1 = (int(a) for a in rows[v, k])
            tb = t0 + torch.arange(TILE)
            p = torch.zeros((B, TILE))
            for lo, hi in _shares(r0, r1):
                ys = torch.arange(lo, hi)
                s = s0[v, ys].long()

                def load(u):                 # x[:, ys, u], 0 off the row
                    ok = (u >= 0) & (u < n)
                    g = x[:, ys[:, None], u.clamp(0, n - 1)]
                    return torch.where(ok, g, torch.zeros(()))

                q = load(tb[None, :] - s[:, None])              # [B, R, T]
                a = (w0[v, ys][:, None] * q).sum(1)
                c = (w1[v, ys][:, None] * q).sum(1)   # tap 1 of bin t + 1
                e = (w1[v, ys] * load((t0 - 1 - s)[:, None])[..., 0]).sum(1)
                p = p + a + torch.cat([e[:, None], c[:, :-1]], 1)
            hi = min(L, t0 + TILE)
            out[v, :, t0:hi] = p[:, :hi - t0]
    return out


@pytest.mark.parametrize("kind", ["monotone", "nonmonotone", "plan64"])
@pytest.mark.parametrize("bf16", [False, True])
def test_fp_in_kernel_order_loses_no_tap(kind, bf16):
    s0, n, L = _tables(kind)
    s0 = t(s0[0])                                   # one subset: [V, n]
    V = s0.shape[0]
    rng = np.random.default_rng(1)
    rnd = shift._bf16_round if bf16 else (lambda a: a)
    x = rnd(t(rng.random((3, n, n), np.float32)))
    frac = t(rng.random((V, n), np.float32))
    w0, w1 = rnd(1 - frac), rnd(frac)
    rows = shift.sweep_row_ranges(s0, n, L)
    got = _fp_kernel_order(x, w0, w1, s0, rows, L)
    want = shift.fp_plane_deposit_plain(x.transpose(0, 1).contiguous(), s0,
                                        s0 + 1, w0, w1, L)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def _bp_kernel_order(T, s0, w0, w1, n):
    """The sweep's BP as bp_gather.cuh sums it with s1 = s0 + 1: a = Σ_v
    w0·T[s0 + j], c = Σ_v w1·T[s0 + j] at the value's column, output
    a[j] + c[j + 1], where c at the warp's next column is its own sum e.
    T [V, B, L], s0/w0/w1 [V, n] → [B, n, n]."""
    V, B, L = T.shape
    out = torch.zeros((B, n, n))
    for j0 in range(0, n, BP_COLS):
        cols = torch.arange(j0, j0 + BP_COLS)
        idx = s0.long()[:, :, None] + cols                    # [V, n, J]
        q = torch.where(cols <= n, torch.gather(
            T, 2, idx.clamp_max(L - 1).reshape(V, 1, -1).expand(-1, B, -1)
        ).reshape(V, B, n, BP_COLS), torch.zeros(()))
        a = (w0[:, None, :, None] * q).sum(0)
        c = (w1[:, None, :, None] * q).sum(0)
        e_idx = (s0.long() + j0 + BP_COLS).clamp_max(L - 1)   # [V, n]
        qe = torch.gather(T, 2, e_idx[:, None, :].expand(-1, B, -1))
        e = (w1[:, None, :] * qe).sum(0) * (j0 + BP_COLS <= n)  # [B, n]
        full = a + torch.cat([c[..., 1:], e[..., None]], -1)
        hi = min(n, j0 + BP_COLS)
        out[..., j0:hi] = full[..., :hi - j0]
    return out


@pytest.mark.parametrize("n", [64, 150])
def test_bp_in_kernel_order_loses_no_tap(n):
    """n = 150: a last block of 22 columns, whose tap-1 sums stop at the
    column past the last output."""
    rng = np.random.default_rng(2)
    V, B, L = 6, 2, 2 * n + 40
    s0 = t(_monotone_starts(rng, 1, V, n, L)[0])
    T = t(rng.random((V, B, L), np.float32))
    frac = t(rng.random((V, n), np.float32))
    got = _bp_kernel_order(T, s0, 1 - frac, frac, n)
    want = shift.bp_shift_accumulate_plain(T, s0, s0 + 1, frac, n)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def _sweep_args():
    rng = np.random.default_rng(3)
    S, Vp, B, n, L = 2, 8, 2, 64, 256
    s0 = t(_monotone_starts(rng, S, Vp, n, L))
    x = t(rng.random((B, n, n), np.float32))
    rf = t(rng.random((S, Vp, B, L), np.float32))
    inv2 = t(rng.random((S, Vp, L), np.float32))
    frac = t(rng.random((S, Vp, n), np.float32))
    nrmi = t(rng.random((S, n, n), np.float32))
    return (x, rf, inv2, frac, s0, nrmi, 0.3), n, L


@pytest.mark.parametrize("fault", ["shape", "row-past-n", "negative-row",
                                   "bounds-past-n"])
def test_sweep_rejects_bad_row_ranges(fault):
    args, n, L = _sweep_args()
    rows = shift.sweep_row_ranges(args[4], n, L)
    bounds = None
    if fault == "shape":
        rows = rows[:, :, :-1].contiguous()
        match = "row_ranges"
    elif fault == "row-past-n":
        rows[1, 3, 2, 1] = n + 1
        match = "row ranges"
    elif fault == "negative-row":
        rows[0, 0, 0, 0] = -1
        match = "row ranges"
    else:
        bounds = (0, n + 1)
        match = "row ranges"
    with pytest.raises(ValueError, match=match):
        shift.os_sart_sweep(*args, row_ranges=rows, row_ranges_bounds=bounds)


def test_sweep_accepts_its_table_and_the_plan_builds_it():
    """A valid table changes nothing on the CPU (the plain version sums
    every row), and the plan's per-drive table is sweep_row_ranges of its
    starts, with its (min, max)."""
    args, n, L = _sweep_args()
    rows = shift.sweep_row_ranges(args[4], n, L)
    torch.testing.assert_close(
        shift.os_sart_sweep(*args, row_ranges=rows),
        shift.os_sart_sweep_plain(*args), rtol=0, atol=0)
    sp = sart_fast._splan_for(FBPGeometry(**SMALL), 6, fold=True, kf=1)
    _, per_drive = sart_fast._norms_for(sp, "cpu")
    for key, d in per_drive.items():
        want = shift.sweep_row_ranges(d["s0"], sp.p.n, sp.group(key).L)
        assert torch.equal(d["rows"], want)
        assert d["rows_bounds"] == (int(want.min()), int(want.max()))

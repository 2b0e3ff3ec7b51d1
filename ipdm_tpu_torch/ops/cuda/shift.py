"""Shifted-window kernels of the fast reconstructors (port of the Pallas
kernels of ipdm_tpu/ops/pallas/shift.py):

* :func:`bp_shift_accumulate_batched` (shift.py:119), the two-tap
  backprojection accumulate
  ``out[b,y,j] = Σ_v (1−f[v,y])·Q[v,b,s0[v,y]+j] + f[v,y]·Q[v,b,s1[v,y]+j]``
  (``csrc/bp_shift.cu``);
* :func:`bp_shift_accumulate` (shift.py:193), the same sum for one signal
  per view, Q2 [V,L] → [n,n] (``csrc/bp_shift.cu``, its own entry);
* :func:`fp_plane_deposit` (shift.py:279), its adjoint, the two-tap row
  deposit ``out[v,b,s_t[v,y]+j] += w_t[v,y]·rows[y,b,j]``
  (``csrc/fp_deposit.cu``);
* :func:`fp_shift_deposit_batched` (shift.py:354) and
  :func:`fp_shift_deposit` (shift.py:625), the same deposit contract for
  rows [n,B,W] and for one image's rows [n,W] → [V,L]
  (``csrc/fp_shift_deposit.cu``);
* :func:`os_sart_sweep` (shift.py:544 ``os_sart_sweep_mm``), one OS-SART
  sweep over a drive axis's subsets: deposit FP, ratio correction, BP,
  relaxed update, clamp, with f32 or bf16-rounded product operands
  (``csrc/os_sart_sweep.cu``);
* :func:`anterp_taps` (shift.py:702), the windowed multi-tap resample
  ``out[v,:,d] = Σ_k W[v,k,d]·P[v,:,qi0[v,d]+k]`` (``csrc/anterp_taps.cu``).

Each wrapper runs its plain PyTorch twin (``*_plain``) for CPU tensors;
for CUDA tensors it launches its kernel or raises (dtype, shape,
contiguity, window bound, launch error) and counts the launch in
``_build.LAUNCHES``. JAX clamps out-of-range indices silently, torch and
CUDA do not, so every wrapper checks its windows on the host. The TPU
kernels' 128-lane padding, view padding to multiples of 8, roll tables,
residue planes and MXU tap matrices have no counterpart here.
"""

from __future__ import annotations

import torch

from ipdm_tpu_torch.ops.cuda import _build

# views per chunk of the plain version: bounds its [Vc, B, n, n] gather
# (16·4·512²·4 B = 64 MiB at the SIEMENS_FBP main path)
_PLAIN_VIEW_CHUNK = 16


def bp_shift_accumulate_plain(Q, s0, s1, frac, n: int):
    """The plain PyTorch version, f32 sums over chunks of views. Q [V,B,L]
    f32; s0, s1 [V,n] int; frac [V,n] f32. Returns [B,n,n] f32."""
    V, B, L = Q.shape
    out = torch.zeros((B, n, n), dtype=torch.float32, device=Q.device)
    iota = torch.arange(n, device=Q.device)
    for v0 in range(0, V, _PLAIN_VIEW_CHUNK):
        v1 = min(V, v0 + _PLAIN_VIEW_CHUNK)
        Qc = Q[v0:v1].float()
        f = frac[v0:v1, None, :, None]

        def taps(s):
            idx = (s[v0:v1].long()[:, :, None] + iota).reshape(v1 - v0, 1, -1)
            g = torch.gather(Qc, 2, idx.expand(-1, B, -1))
            return g.reshape(v1 - v0, B, n, n)

        out += ((1 - f) * taps(s0) + f * taps(s1)).sum(dim=0)
    return out


def _check_windows(s0, s1, n: int, L: int,
                   name: str = "bp_shift_accumulate", bounds=None) -> None:
    # JAX clamps out-of-range gather indices silently; neither torch
    # indexing nor the kernel does, so the window bound is checked here:
    # on ``bounds`` = (min, max) of the starts where the caller read them
    # once from a static table's host copy, else with one host read
    if bounds is not None:
        lo, hi = bounds
    else:
        m0, m1, x0, x1 = torch.stack([s0.min(), s1.min(), s0.max(),
                                      s1.max()]).tolist()
        lo, hi = min(m0, m1), max(x0, x1)
    if lo < 0 or hi + n > L:
        raise ValueError(f"{name}: window starts span [{lo}, {hi}], need "
                         f"0 <= s and s + {n} <= L (L={L})")


def _check_cuda(name: str, device, tensors) -> None:
    """dtype, device and contiguity of a kernel's operands."""
    for arg, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dt}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous tensor "
                             f"on {device}")


def _check_shapes(name: str, tensors) -> None:
    for arg, t, shape in tensors:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")


def _device_of(name: str, t):
    """'cpu' or 'cuda' for a wrapper's leading operand, else raise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def bp_shift_accumulate_batched(Q, s0, s1, frac, n: int):
    """Σ_v two-tap row shifts of the per-view signals Q [V,B,L] (f32) at
    starts s0, s1 [V,n] (int32) with weights frac [V,n] (f32); returns
    [B,n,n] f32. Requires 0 ≤ s and s + n ≤ L (checked)."""
    name = "bp_shift_accumulate"
    if Q.dim() != 3:
        raise ValueError(f"{name}: Q {tuple(Q.shape)} must be [V, B, L]")
    V, B, L = Q.shape
    _check_shapes(name, [(a, t, (V, n)) for a, t in
                         (("s0", s0), ("s1", s1), ("frac", frac))])
    if V:
        _check_windows(s0, s1, n, L)
    if _device_of(name, Q) == "cpu":
        return bp_shift_accumulate_plain(Q, s0, s1, frac, n)
    _check_cuda(name, Q.device, [("Q", Q, torch.float32),
                                 ("s0", s0, torch.int32),
                                 ("s1", s1, torch.int32),
                                 ("frac", frac, torch.float32)])
    out = torch.empty((B, n, n), dtype=torch.float32, device=Q.device)
    lib = _build.library()
    code = lib.bp_shift_launch(Q.data_ptr(), s0.data_ptr(), s1.data_ptr(),
                               frac.data_ptr(), out.data_ptr(), V, B, L, n,
                               _build.stream_ptr(Q))
    _build.check(code, "bp_shift")
    _build.LAUNCHES["bp_shift"] += 1
    return out


def bp_shift_accumulate(Q2, s0, s1, frac, n: int):
    """Σ_v two-tap row shifts of one signal per view, Q2 [V,L] (f32), at
    starts s0, s1 [V,n] (int32) with weights frac [V,n] (f32); returns
    [n,n] f32. Requires 0 ≤ s and s + n ≤ L (checked). Any view count: the
    TPU kernel's multiple of 8 is its block size."""
    name = "bp_shift_accumulate"
    if Q2.dim() != 2:
        raise ValueError(f"{name}: Q2 {tuple(Q2.shape)} must be [V, L]")
    V, L = Q2.shape
    _check_shapes(name, [(a, t, (V, n)) for a, t in
                         (("s0", s0), ("s1", s1), ("frac", frac))])
    if V:
        _check_windows(s0, s1, n, L, name)
    if _device_of(name, Q2) == "cpu":
        return bp_shift_accumulate_plain(Q2[:, None, :], s0, s1, frac, n)[0]
    _check_cuda(name, Q2.device, [("Q2", Q2, torch.float32),
                                  ("s0", s0, torch.int32),
                                  ("s1", s1, torch.int32),
                                  ("frac", frac, torch.float32)])
    out = torch.empty((n, n), dtype=torch.float32, device=Q2.device)
    code = _build.library().bp_shift_single_launch(
        Q2.data_ptr(), s0.data_ptr(), s1.data_ptr(), frac.data_ptr(),
        out.data_ptr(), V, L, n, _build.stream_ptr(Q2))
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Two-tap plane deposit (the fast SART's forward projection)
# ---------------------------------------------------------------------------


def fp_plane_deposit_plain(rows, s0, s1, w0, w1, L: int):
    """The plain PyTorch version: a scatter-add of the weighted rows over
    chunks of views. rows [n,B,W] f32; s0, s1 [V,n] int; w0, w1 [V,n] f32.
    Returns [V,B,L] f32."""
    n, B, W = rows.shape
    V = s0.shape[0]
    out = torch.zeros((V * B, L), dtype=torch.float32, device=rows.device)
    r = rows.float().permute(1, 0, 2)                      # [B, n, W]
    iota = torch.arange(W, device=rows.device)
    # views per chunk: bounds the [Vc, B, n·W] values and indices
    # (16 views · 4 · 512² · 12 B = 200 MB at the SART sweep's shapes)
    vc = max(1, (1 << 24) // max(1, B * n * W))
    for v0 in range(0, V, vc):
        v1 = min(V, v0 + vc)
        acc = out[v0 * B:v1 * B].view(v1 - v0, B, L)
        for s, w in ((s0, w0), (s1, w1)):
            idx = (s[v0:v1].long()[:, :, None] + iota).reshape(v1 - v0, 1, -1)
            val = w[v0:v1, None, :, None].float() * r[None]  # [Vc,B,n,W]
            acc.scatter_add_(2, idx.expand(-1, B, -1),
                             val.reshape(v1 - v0, B, -1))
    return out.view(V, B, L)


def fp_plane_deposit(rows, s0, s1, w0, w1, L: int):
    """out[v,b,s_t[v,y]+j] += w_t[v,y]·rows[y,b,j] for t ∈ {0,1}. rows
    [n,B,W] f32; s0, s1 [V,n] int32 with 0 ≤ s and s + W ≤ L (checked);
    w0, w1 [V,n] f32. Returns [V,B,L] f32."""
    name = "fp_plane_deposit"
    if rows.dim() != 3 or s0.dim() != 2:
        raise ValueError(f"{name}: rows must be [n,B,W] and s0 [V,n]")
    n, B, W = rows.shape
    V = s0.shape[0]
    _check_shapes(name, [(a, t, (V, n)) for a, t in
                         (("s0", s0), ("s1", s1), ("w0", w0), ("w1", w1))])
    _check_windows(s0, s1, W, L, name)
    if _device_of(name, rows) == "cpu":
        return fp_plane_deposit_plain(rows, s0, s1, w0, w1, L)
    f32, i32 = torch.float32, torch.int32
    _check_cuda(name, rows.device, [("rows", rows, f32), ("s0", s0, i32),
                                    ("s1", s1, i32), ("w0", w0, f32),
                                    ("w1", w1, f32)])
    out = torch.empty((V, B, L), dtype=f32, device=rows.device)
    code = _build.library().fp_deposit_launch(
        rows.data_ptr(), s0.data_ptr(), s1.data_ptr(), w0.data_ptr(),
        w1.data_ptr(), out.data_ptr(), V, B, W, L, n,
        _build.stream_ptr(rows))
    _build.check(code, name)
    _build.LAUNCHES["fp_plane_deposit"] += 1
    return out


def _deposit_operands(name: str, rows, s0, s1, w0, w1, W: int, L: int):
    """Shape and window checks shared by the two shift deposits; returns
    V. The TPU kernels' 128-multiples of W and L and their start limit
    L − W − 128 come from their aligned windows; here 0 ≤ s and
    s + W ≤ L is the whole contract."""
    if s0.dim() != 2:
        raise ValueError(f"{name}: s0 must be [V,n]")
    V, n = s0.shape[0], rows.shape[0]
    _check_shapes(name, [(a, t, (V, n)) for a, t in
                         (("s0", s0), ("s1", s1), ("w0", w0), ("w1", w1))])
    _check_windows(s0, s1, W, L, name)
    return V


def _deposit_cuda(name: str, rows, s0, s1, w0, w1) -> None:
    f32, i32 = torch.float32, torch.int32
    _check_cuda(name, rows.device, [("rows", rows, f32), ("s0", s0, i32),
                                    ("s1", s1, i32), ("w0", w0, f32),
                                    ("w1", w1, f32)])


def fp_shift_deposit_batched(rows, s0, s1, w0, w1, L: int):
    """out[v,b,s_t[v,y]+j] += w_t[v,y]·rows[y,b,j] for t ∈ {0,1}:
    :func:`fp_plane_deposit`'s contract through the kernel that serves a
    whole batch per block. rows [n,B,W] f32; s0, s1 [V,n] int32 with 0 ≤ s
    and s + W ≤ L (checked); w0, w1 [V,n] f32. Returns [V,B,L] f32."""
    name = "fp_shift_deposit_batched"
    if rows.dim() != 3:
        raise ValueError(f"{name}: rows must be [n,B,W]")
    n, B, W = rows.shape
    V = _deposit_operands(name, rows, s0, s1, w0, w1, W, L)
    if _device_of(name, rows) == "cpu":
        return fp_plane_deposit_plain(rows, s0, s1, w0, w1, L)
    _deposit_cuda(name, rows, s0, s1, w0, w1)
    out = torch.empty((V, B, L), dtype=torch.float32, device=rows.device)
    code = _build.library().fp_shift_deposit_batched_launch(
        rows.data_ptr(), s0.data_ptr(), s1.data_ptr(), w0.data_ptr(),
        w1.data_ptr(), out.data_ptr(), V, B, W, L, n,
        _build.stream_ptr(rows))
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return out


def fp_shift_deposit_plain(rows, s0, s1, w0, w1, L: int):
    """The plain PyTorch version of :func:`fp_shift_deposit`: the batched
    scatter-add at B = 1. rows [n,W]; returns [V,L] f32."""
    return fp_plane_deposit_plain(rows[:, None, :], s0, s1, w0, w1, L)[:, 0]


def fp_shift_deposit(rows, s0, s1, w0, w1, L: int):
    """out[v,s_t[v,y]+j] += w_t[v,y]·rows[y,j] for t ∈ {0,1}: one image's
    rows [n,W] f32 (W the deposit width) into per-view signals [V,L] f32.
    s0, s1 [V,n] int32 with 0 ≤ s and s + W ≤ L (checked); w0, w1 [V,n]
    f32. Any view count."""
    name = "fp_shift_deposit"
    if rows.dim() != 2:
        raise ValueError(f"{name}: rows must be [n,W]")
    n, W = rows.shape
    V = _deposit_operands(name, rows, s0, s1, w0, w1, W, L)
    if _device_of(name, rows) == "cpu":
        return fp_shift_deposit_plain(rows, s0, s1, w0, w1, L)
    _deposit_cuda(name, rows, s0, s1, w0, w1)
    out = torch.empty((V, L), dtype=torch.float32, device=rows.device)
    code = _build.library().fp_shift_deposit_launch(
        rows.data_ptr(), s0.data_ptr(), s1.data_ptr(), w0.data_ptr(),
        w1.data_ptr(), out.data_ptr(), V, W, L, n, _build.stream_ptr(rows))
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# One OS-SART sweep over a drive axis's subsets
# ---------------------------------------------------------------------------


def _sweep_shapes(x, rf, inv2, frac, s0, nrmi):
    if x.dim() != 3 or rf.dim() != 4:
        raise ValueError("os_sart_sweep: x must be [B,n,n] and rf [S,Vp,B,L]")
    B, n, _ = x.shape
    S, Vp, _, L = rf.shape
    _check_shapes("os_sart_sweep", [
        ("x", x, (B, n, n)), ("rf", rf, (S, Vp, B, L)),
        ("inv2", inv2, (S, Vp, L)), ("frac", frac, (S, Vp, n)),
        ("s0", s0, (S, Vp, n)), ("nrmi", nrmi, (S, n, n))])
    return S, Vp, B, n, L


def _bf16_round(t):
    """t rounded to bf16 (nearest even) and back to f32: the value a bf16
    matmul operand carries."""
    return t.to(torch.bfloat16).float()


def os_sart_sweep_plain(x, rf, inv2, frac, s0, nrmi, lam: float,
                        bf16: bool = False):
    """The plain PyTorch version: per subset, the deposit FP
    (:func:`fp_plane_deposit_plain`), the ratio correction, the BP, the
    relaxed update and the clamp. With ``bf16`` the tap weights (1−f, f),
    the image (FP) and the correction (BP) are rounded to bf16 before
    their products and the products summed in f32, which is what the TPU
    kernel's bf16 matmul against its two-hot tap matrix computes. Returns
    the updated [B,n,n] image (x is not changed)."""
    S, Vp, B, n, L = _sweep_shapes(x, rf, inv2, frac, s0, nrmi)
    rnd = _bf16_round if bf16 else (lambda t: t)
    x = x.float()
    iota = torch.arange(n, device=x.device)
    for s in range(S):
        s1 = s0[s] + 1
        w0, w1 = rnd(1 - frac[s]), rnd(frac[s])
        T = fp_plane_deposit_plain(rnd(x).transpose(0, 1), s0[s], s1,
                                   w0, w1, L)
        corr = rnd(rf[s] - T * inv2[s][:, None, :])
        # BP with the two tap weights as given (bp_shift_accumulate_plain
        # forms 1 − f itself, which the bf16 mode rounds first)
        bp = torch.zeros_like(x)
        for v0 in range(0, Vp, _PLAIN_VIEW_CHUNK):
            sl = slice(v0, min(Vp, v0 + _PLAIN_VIEW_CHUNK))
            nv = sl.stop - v0

            def taps(st):
                idx = (st[sl].long()[:, :, None] + iota).reshape(nv, 1, -1)
                return torch.gather(corr[sl], 2, idx.expand(-1, B, -1)
                                    ).reshape(nv, B, n, n)

            bp += (w0[sl, None, :, None] * taps(s0[s])
                   + w1[sl, None, :, None] * taps(s1)).sum(dim=0)
        x = (x + lam * nrmi[s] * bp).clamp_min(0.0)
    return x


def os_sart_sweep(x, rf, inv2, frac, s0, nrmi, lam: float,
                  s0_bounds=None, bf16: bool = False):
    """One OS-SART sweep over a drive axis's subsets, in order
    (shift.py:544 os_sart_sweep_mm; ``bf16`` is its bf16 operand mode: tap
    weights, image and correction rounded to bf16 before each product, f32
    sums). x: [B,n,n] drive-frame image;
    rf: [S,Vp,B,L] masked measured ratios on the fine grid; inv2:
    [S,Vp,L] masked scale/n_fine; frac, s0: [S,Vp,n] tap fractions and
    int32 starts (the second tap starts at s0 + 1; 0 ≤ s0 and
    s0 + n < L, checked); nrmi: [S,n,n] per-subset 1/BP-norm; lam: the
    relaxation; s0_bounds: (min, max) of s0 when the caller knows them
    (a plan table), which spares the device read of the window check.
    Returns a new [B,n,n] image; on the card one call is 2·S kernel
    launches on one stream, counted as one."""
    name = "os_sart_sweep"
    S, Vp, B, n, L = _sweep_shapes(x, rf, inv2, frac, s0, nrmi)
    _check_windows(s0, s0, n + 1, L, name, s0_bounds)
    if _device_of(name, x) == "cpu":
        return os_sart_sweep_plain(x, rf, inv2, frac, s0, nrmi, lam,
                                   bf16=bf16)
    f32 = torch.float32
    _check_cuda(name, x.device, [
        ("x", x, f32), ("rf", rf, f32), ("inv2", inv2, f32),
        ("frac", frac, f32), ("s0", s0, torch.int32), ("nrmi", nrmi, f32)])
    out = x.clone()    # the JAX function returns a new array
    T = torch.empty((Vp, B, L), dtype=f32, device=x.device)
    code = _build.library().os_sart_sweep_launch(
        out.data_ptr(), rf.data_ptr(), inv2.data_ptr(), frac.data_ptr(),
        s0.data_ptr(), nrmi.data_ptr(), T.data_ptr(), S, Vp, B, n, L,
        float(lam), int(bool(bf16)), _build.stream_ptr(x))
    _build.check(code, name)
    _build.LAUNCHES["os_sart_sweep_bf16" if bf16 else "os_sart_sweep"] += 1
    return out


# ---------------------------------------------------------------------------
# Windowed multi-tap resample
# ---------------------------------------------------------------------------

# views per chunk of the plain version: bounds its [Vc, B, Lp] gathers
_ANTERP_VIEW_CHUNK = 64


def anterp_taps_plain(P, qi0, W):
    """The plain PyTorch version: per tap a gather and a product, over
    chunks of views. P [V,B,Ntp] f32; qi0 [V,Lp] int; W [V,Wt,Lp] f32.
    Returns [V,B,Lp] f32."""
    V, B, _ = P.shape
    Wt, Lp = W.shape[1], W.shape[2]
    out = torch.zeros((V, B, Lp), dtype=torch.float32, device=P.device)
    for v0 in range(0, V, _ANTERP_VIEW_CHUNK):
        v1 = min(V, v0 + _ANTERP_VIEW_CHUNK)
        Pc = P[v0:v1].float()
        for k in range(Wt):
            idx = (qi0[v0:v1].long() + k)[:, None, :].expand(-1, B, -1)
            out[v0:v1] += W[v0:v1, k, None, :].float() * torch.gather(
                Pc, 2, idx)
    return out


def anterp_taps(P, qi0, W, qi0_bounds=None):
    """out[v,:,d] = Σ_k W[v,k,d]·P[v,:,qi0[v,d]+k]. P [V,B,Ntp] f32; qi0
    [V,Lp] int32 with 0 ≤ qi0 and qi0 + Wt − 1 < Ntp (checked, on
    qi0_bounds = (min, max) of qi0 when the caller knows them; the TPU
    kernel's monotone-within-288 contract does not apply); W [V,Wt,Lp]
    f32. Returns [V,B,Lp] f32."""
    name = "anterp_taps"
    if P.dim() != 3 or W.dim() != 3:
        raise ValueError(f"{name}: P must be [V,B,Ntp] and W [V,Wt,Lp]")
    V, B, Ntp = P.shape
    Wt, Lp = W.shape[1], W.shape[2]
    _check_shapes(name, [("qi0", qi0, (V, Lp)), ("W", W, (V, Wt, Lp))])
    _check_windows(qi0, qi0, Wt, Ntp, name, qi0_bounds)
    if _device_of(name, P) == "cpu":
        return anterp_taps_plain(P, qi0, W)
    _check_cuda(name, P.device, [("P", P, torch.float32),
                                 ("qi0", qi0, torch.int32),
                                 ("W", W, torch.float32)])
    out = torch.empty((V, B, Lp), dtype=torch.float32, device=P.device)
    code = _build.library().anterp_taps_launch(
        P.data_ptr(), qi0.data_ptr(), W.data_ptr(), out.data_ptr(), V, B,
        Ntp, Lp, Wt, _build.stream_ptr(P))
    _build.check(code, name)
    _build.LAUNCHES["anterp_taps"] += 1
    return out

"""Batched two-tap shifted-window backprojection accumulate.

Port of the Pallas kernel ipdm_tpu/ops/pallas/shift.py:119
bp_shift_accumulate_batched:

    out[b, y, j] = Σ_v (1 − f[v,y])·Q[v, b, s0[v,y]+j] + f[v,y]·Q[v, b, s1[v,y]+j]

On a CUDA tensor :func:`bp_shift_accumulate_batched` launches the kernel
of ``csrc/bp_shift.cu``; on a CPU tensor it runs
:func:`bp_shift_accumulate_plain`. The TPU kernel's 128-lane padding,
view padding to multiples of 8 and roll tables have no counterpart: the
kernel takes the unpadded [V, B, L] signal and any n.
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


def _check_windows(s0, s1, n: int, L: int) -> None:
    # JAX clamps out-of-range gather indices silently; neither torch
    # indexing nor the kernel does, so the window bound is checked here
    # (one host read for the four bounds)
    m0, m1, x0, x1 = torch.stack([s0.min(), s1.min(), s0.max(),
                                  s1.max()]).tolist()
    lo, hi = min(m0, m1), max(x0, x1)
    if lo < 0 or hi + n > L:
        raise ValueError(f"bp_shift_accumulate: window starts span "
                         f"[{lo}, {hi}], need 0 <= s and s + n <= L "
                         f"(n={n}, L={L})")


def bp_shift_accumulate_batched(Q, s0, s1, frac, n: int):
    """Σ_v two-tap row shifts of the per-view signals Q [V,B,L] (f32) at
    starts s0, s1 [V,n] (int32) with weights frac [V,n] (f32); returns
    [B,n,n] f32. Requires 0 ≤ s and s + n ≤ L (checked)."""
    if Q.dim() != 3:
        raise ValueError(f"bp_shift_accumulate: Q {tuple(Q.shape)} must be "
                         "[V, B, L]")
    V, B, L = Q.shape
    for name, t in (("s0", s0), ("s1", s1), ("frac", frac)):
        if tuple(t.shape) != (V, n):
            raise ValueError(f"bp_shift_accumulate: {name} is "
                             f"{tuple(t.shape)}, expected {(V, n)}")
    if V:
        _check_windows(s0, s1, n, L)
    if Q.device.type == "cpu":
        return bp_shift_accumulate_plain(Q, s0, s1, frac, n)
    if Q.device.type != "cuda":
        raise ValueError(f"bp_shift_accumulate: unsupported device {Q.device}")
    for name, t, dt in (("Q", Q, torch.float32), ("s0", s0, torch.int32),
                        ("s1", s1, torch.int32), ("frac", frac, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"bp_shift_accumulate: {name} is {t.dtype}, "
                            f"expected {dt}")
        if t.device != Q.device or not t.is_contiguous():
            raise ValueError(f"bp_shift_accumulate: {name} must be a "
                             f"contiguous tensor on {Q.device}")
    out = torch.empty((B, n, n), dtype=torch.float32, device=Q.device)
    lib = _build.library()
    code = lib.bp_shift_launch(Q.data_ptr(), s0.data_ptr(), s1.data_ptr(),
                               frac.data_ptr(), out.data_ptr(), V, B, L, n,
                               _build.stream_ptr(Q))
    _build.check(code, "bp_shift")
    _build.LAUNCHES["bp_shift"] += 1
    return out

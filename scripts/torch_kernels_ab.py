#!/usr/bin/env python3
"""Time the port's deposit, anterp_taps and flash-attention kernels
against a parent commit's, on one NVIDIA GPU, in one process.

    python3 scripts/torch_kernels_ab.py --parent DIR [--reps 20] [--out F]
        [--kernels deposit anterp flash_fwd flash_bwd] [--same-bits]

DIR is a checkout of the parent commit (``git archive <commit> | tar -x
-C DIR``). The script builds DIR's ``ipdm_tpu_torch/csrc`` with the same
nvcc flags into its own library, drives this tree's main paths once to
record the inputs the kernels get there (an OS-SART convert of four
full-width sinograms with its plan built anew: the norms' deposits #6 and
anterp_taps; ``project_fast`` of two 512² phantoms: the batched deposit
#8, the single deposit #9 on one of its items, anterp_taps at Wt = 6),
and on each input:

* holds this tree's kernel (through its wrapper) against the plain
  version with chip_smoke.py's summation-order bound, and prints the
  parent kernel's distance from it;
* the flash backward (``flash_bwd_dq`` / ``flash_bwd_dkv``): one eval and
  backward of the proj UNet (2000×912, T = 7125) and the img UNet (512²,
  T = 4096) at B = 1, seeded random weights, in bf16 (chip_smoke.py's
  slice widths) and in f32 (the train presets'), record the backward's
  inputs; on each, the parent's kernels and this tree's are held to the
  plain backward at chip_smoke.py's rule;
* the flash forward on the same recorded q, k, v (T = 7125 and 4096,
  bf16 and f32): the parent's kernel and this tree's against the plain
  forward (out at chip_smoke.py's rule, the lse by its lse_check), their
  distance from each other (bf16: none allowed: out and lse bit for
  bit; the backward's dq, dk, dv and D printed too), and SDPA's time in
  the same call beside the A B B A; a parent whose flash entries take
  the head dimension (attention.py FLASH_HEAD_DIMS) gets the tensors'
  (and a null split scratch where its backward entries take one);
* where the parent's kernels take the head dimension, its forward and
  backward against this tree's at head dims 8, 16 and 32 (both dtypes)
  on seeded inputs at T = 4097: the largest parent − new distance of
  every output;
* times the parent's kernel (launched bare) and this tree's (through
  its wrapper, with the host bounds the main path passes), back to back
  with the stream held by a spin kernel (device time), in the order
  parent, new, new, parent; and this tree's wrapper alone, CUDA events
  around back-to-back calls (host time included where it is longer).

The last line is a JSON object with the times; with ``--out`` it is also
written to that file. With ``--same-bits`` the script exits 1 unless
every output of every kernel it ran is bit-equal to the parent's.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
# the parent's C entry points that this script calls, with their argtypes
PARENT_SIGNATURES = {
    # rows, s0, s1, w0, w1, out, V, B, W, L, n, stream
    "fp_deposit_launch": [P, P, P, P, P, P, I, I, I, I, I, P],
    "fp_shift_deposit_batched_launch": [P, P, P, P, P, P, I, I, I, I, I, P],
    # rows, s0, s1, w0, w1, out, V, W, L, n, stream
    "fp_shift_deposit_launch": [P, P, P, P, P, P, I, I, I, I, P],
    # P, qi0, W, out, V, B, Ntp, Lp, Wt, stream
    "anterp_taps_launch": [P, P, P, P, I, I, I, I, I, P],
    # q, k, v, out, lse, BH, T, scale_log2, stream
    "flash_attn_launch": [P, P, P, P, P, I, I, ctypes.c_float, P],
    # as flash_attn_launch, with the split scratch after v (a parent
    # whose f32 forward is csrc/flash_attn_f32.cu takes none: see
    # parent_f32_takes_split)
    "flash_attn_f32_launch": [P, P, P, P, P, P, I, I, ctypes.c_float, P],
    # q, k, v, out, do, lse, D, dq, BH, T, scale_log2, scale2, bf16, stream
    "flash_bwd_dq_launch": [P, P, P, P, P, P, P, P, I, I, ctypes.c_float,
                            ctypes.c_float, I, P],
    # q, k, v, do, lse, D, dk, dv, BH, T, scale_log2, scale2, bf16, stream
    "flash_bwd_dkv_launch": [P, P, P, P, P, P, P, P, I, I, ctypes.c_float,
                             ctypes.c_float, I, P],
}


# the flash entries that take the head dimension after T in a parent
# whose kernels are instantiated per head dim (attention.py
# FLASH_HEAD_DIMS): see parent_takes_hd
HD_ENTRIES = ("flash_attn_launch", "flash_attn_f32_launch",
              "flash_bwd_dq_launch", "flash_bwd_dkv_launch")


def parent_takes_hd(parent: Path) -> bool:
    """Whether the parent's flash entries take the head dimension (an int
    after T) or are the head-dim-64 kernels alone."""
    return "FLASH_HEAD_DIMS" in (parent / "ipdm_tpu_torch" / "ops" / "cuda"
                                 / "attention.py").read_text()


def parent_bwd_takes_split(parent: Path) -> bool:
    """Whether the parent's flash backward entries take a split scratch
    pointer after dq / dv (the f32 hd-128 instances' hi and lo of q, k,
    v, do)."""
    return "_bwd_split" in (parent / "ipdm_tpu_torch" / "ops" / "cuda"
                            / "attention.py").read_text()


def parent_f32_takes_split(parent: Path) -> bool:
    """Whether the parent's flash_attn_f32_launch takes the split scratch
    (its f32 forward in csrc/flash_attn.cu) or not (the CUDA-core kernel
    of csrc/flash_attn_f32.cu)."""
    return not (parent / "ipdm_tpu_torch" / "csrc"
                / "flash_attn_f32.cu").exists()


def build_parent(parent: Path) -> ctypes.CDLL:
    """nvcc of the parent's csrc/*.cu (one process per source, all at
    once) with this tree's flags, linked into one library."""
    from ipdm_tpu_torch.ops.cuda import _build

    src = parent / "ipdm_tpu_torch" / "csrc"
    out = Path(tempfile.mkdtemp(prefix="ab-parent-", dir=parent))
    nvcc = _build._nvcc()
    procs = []
    for cu in sorted(src.glob("*.cu")):
        obj = out / (cu.stem + ".o")
        procs.append((cu, obj, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(src), "-c", str(cu), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for cu, _obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {cu.name}:\n{log.decode()}")
    lib_path = out / "libparent.so"
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *[str(o) for _c, o, _p in procs]], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in PARENT_SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:   # a tree whose deposits share one launcher
            if (name == "flash_attn_f32_launch"
                    and not parent_f32_takes_split(parent)):
                argtypes = argtypes[:3] + argtypes[4:]
            if name in HD_ENTRIES and parent_takes_hd(parent):
                at = argtypes.index(I) + 2    # after BH, T
                argtypes = argtypes[:at] + [I] + argtypes[at:]
            if (name in ("flash_bwd_dq_launch", "flash_bwd_dkv_launch")
                    and parent_bwd_takes_split(parent)):
                argtypes = argtypes[:8] + [P] + argtypes[8:]
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.f32_takes_split = parent_f32_takes_split(parent)
    lib.takes_hd = parent_takes_hd(parent)
    # the split scratch pointer of the parent's backward entries: null, as
    # no case here runs the f32 hd-128 instances that read it
    lib.split_args = (None,) if parent_bwd_takes_split(parent) else ()
    return lib


def hd_args(lib, q) -> tuple:
    """The head-dim argument to pass the parent's flash entries after T
    (none where they are the head-dim-64 kernels alone)."""
    return (q.shape[2],) if lib.takes_hd else ()


def record_inputs(seed: int):
    """The deposit and anterp wrappers' inputs on the ART plan's build,
    the ART convert's resample and project_fast."""
    import numpy as np
    import torch
    from ipdm_tpu_torch.recon import sart_fast
    from ipdm_tpu_torch.recon.convertor import Convertor
    from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP as g
    from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom

    rng = np.random.default_rng(seed)
    sino = torch.as_tensor(rng.random((4, 2000, 912), np.float32) * 4.0,
                           device="cuda")
    sart_fast._SPLANS.clear()
    art = [cs.Recorder(sart_fast, nm) for nm in ("fp_plane_deposit",
                                                 "anterp_taps")]
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        for r in art:
            stack.enter_context(r)
        Convertor("ART", nstart=10, nsubsets=40, ntv=0)(sino)
    vol = torch.as_tensor(np.stack([random_ellipse_phantom(512, rng)
                                    for _ in range(2)]).astype(np.float32),
                          device="cuda")
    fp = [cs.Recorder(sart_fast, nm) for nm in ("fp_shift_deposit_batched",
                                                "anterp_taps")]
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        for r in fp:
            stack.enter_context(r)
        sart_fast.project_fast(vol, g, g.N, float(g.nda[0]), float(g.da))
    torch.cuda.synchronize()
    deposits6, anterp_art = art[0].calls, art[1].calls
    deposits8, anterp_fp = fp[0].calls, fp[1].calls
    # the plan's norms deposit each drive twice on the same inputs (its
    # ray-sum denominator and its fine-grid valid mask): one of each
    return dict(
        d6=[deposits6[0], deposits6[-1]],
        d8=deposits8,
        a_resample=[c for c in anterp_art if c[0][0].shape[1] > 1],
        a_plan=[c for c in anterp_art if c[0][0].shape[1] == 1],
        a_fp=anterp_fp)


def spin_ms(launch, reps: int) -> float:
    """Device ms per launch: a spin kernel holds the stream while the host
    enqueues ``reps`` launches, so they run back to back."""
    import torch
    launch()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))
    e0.record()
    for _ in range(reps):
        launch()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def abba(parent_launch, new_launch, reps: int) -> dict:
    order = [("parent", parent_launch), ("new", new_launch),
             ("new", new_launch), ("parent", parent_launch)]
    got = {"parent": [], "new": []}
    for side, fn in order:
        got[side].append(spin_ms(fn, reps))
    return got


def deposit_case(lib, label, entry, args, kw, reps, single=False):
    """One deposit input: the new wrapper against the plain version, the
    parent's kernel against the new, both timed A B B A."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build, shift

    rows, s0, s1, w0, w1, L = args
    if single:
        rows = rows[:, rows.shape[1] - 1].contiguous()
        wrap = lambda: shift.fp_shift_deposit(rows, s0, s1, w0, w1, L, **kw)
        plain = shift.fp_shift_deposit_plain(rows, s0, s1, w0, w1, L)
        absum = shift.fp_shift_deposit_plain(rows.abs(), s0, s1, w0.abs(),
                                             w1.abs(), L)
        n, W = rows.shape
        B = 1
    else:
        wrap = {"fp_plane_deposit": shift.fp_plane_deposit,
                "fp_shift_deposit_batched": shift.fp_shift_deposit_batched}[
            label]
        wrap = (lambda f: lambda: f(rows, s0, s1, w0, w1, L, **kw))(wrap)
        plain = shift.fp_plane_deposit_plain(rows, s0, s1, w0, w1, L)
        absum = shift.fp_plane_deposit_plain(rows.abs(), s0, s1, w0.abs(),
                                             w1.abs(), L)
        n, B, W = rows.shape
    V = s0.shape[0]
    new = wrap()
    err, msg = cs._sum_bound_check(label, new, plain, absum, 2 * n)
    out = torch.empty_like(new)
    if not hasattr(lib, entry):
        entry, single_dims = "fp_deposit_launch", False
    else:
        single_dims = single
    fn = getattr(lib, entry)
    stream = _build.stream_ptr(rows)
    ptrs = [t.data_ptr() for t in (rows, s0, s1, w0, w1, out)]
    dims = [V, W, L, n] if single_dims else [V, B, W, L, n]

    def parent():
        _build.check(fn(*ptrs, *dims, stream), "parent " + entry)

    parent()
    torch.cuda.synchronize()
    gap = float((out - new).abs().max())
    t = abba(parent, wrap, reps)
    wrapper_ms = cs.cuda_ms(wrap, reps)
    live = int((w0 != 0).any(dim=1).sum())
    bnd = cs.bound_ms(4 * (n * B * W + 4 * V * n + V * B * L),
                      4 * live * n * B * W, cs.F32_FLOPS)
    res = dict(kernel=label, V=V, B=B, n=n, W=W, L=L, err=err,
               parent_gap=gap, parent_ms=t["parent"], new_ms=t["new"],
               wrapper_ms=wrapper_ms,
               bound_ms=max(bnd["bytes_ms"], bnd["ops_ms"]))
    cs.log(f"ab: {label} V={V} B={B} n={n} W={W} L={L}: {msg}; parent − new "
           f"max |diff| {gap:.3e}; device ms parent {t['parent'][0]:.4f}, "
           f"new {t['new'][0]:.4f}, new {t['new'][1]:.4f}, parent "
           f"{t['parent'][1]:.4f}; new through its wrapper {wrapper_ms:.4f} "
           f"ms; bound {res['bound_ms']:.4f} ms")
    return res


def anterp_case(lib, label, args, kw, reps):
    import torch
    from ipdm_tpu_torch.ops.cuda import _build, shift

    Pm, qi0, W = args
    V, B, Ntp = Pm.shape
    Wt, Lp = W.shape[1], W.shape[2]
    wrap = lambda: shift.anterp_taps(Pm, qi0, W, **kw)
    new = wrap()
    err, msg = cs._sum_bound_check(
        label, new, shift.anterp_taps_plain(Pm, qi0, W),
        shift.anterp_taps_plain(Pm.abs(), qi0, W.abs()), Wt)
    out = torch.empty_like(new)
    stream = _build.stream_ptr(Pm)

    def parent():
        _build.check(lib.anterp_taps_launch(
            Pm.data_ptr(), qi0.data_ptr(), W.data_ptr(), out.data_ptr(), V,
            B, Ntp, Lp, Wt, stream), "parent anterp_taps")

    parent()
    torch.cuda.synchronize()
    gap = float((out - new).abs().max())
    t = abba(parent, wrap, reps)
    wrapper_ms = cs.cuda_ms(wrap, reps)
    bnd = cs.bound_ms(4 * (V * B * Ntp + V * Lp + V * Wt * Lp + V * B * Lp),
                      2 * Wt * V * B * Lp, cs.F32_FLOPS)
    res = dict(kernel="anterp_taps", case=label, V=V, B=B, Wt=Wt, Lp=Lp,
               Ntp=Ntp, err=err, parent_gap=gap, parent_ms=t["parent"],
               new_ms=t["new"], wrapper_ms=wrapper_ms,
               bound_ms=max(bnd["bytes_ms"], bnd["ops_ms"]))
    cs.log(f"ab: anterp_taps ({label}) V={V} B={B} Wt={Wt} Lp={Lp} "
           f"Ntp={Ntp}: {msg}; parent − new max |diff| {gap:.3e}; device "
           f"ms parent {t['parent'][0]:.4f}, new {t['new'][0]:.4f}, new "
           f"{t['new'][1]:.4f}, parent {t['parent'][1]:.4f}; new through its "
           f"wrapper {wrapper_ms:.4f} ms; bound {res['bound_ms']:.4f} ms")
    return res


def record_flash_bwd(seed: int):
    """(dtype name, the flash backward's first call) of one eval and
    backward of each UNet at B = 1: bf16 at chip_smoke.py's slice widths,
    f32 at the train presets'."""
    import torch
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import attention

    calls = []
    t = torch.full((1,), 7, dtype=torch.long, device="cuda")
    for dtype_name in ("bfloat16", "float32"):
        for domain, shape in (("proj", (1, 1, 2000, 912)),
                              ("img", (1, 1, 512, 512))):
            torch.manual_seed(seed)
            opt = (cs.SLICE_OPT if dtype_name == "bfloat16" else
                   cs._train_preset(domain))
            model = build_unet(opt, domain, device="cuda")
            x = torch.rand(shape, device="cuda")
            r = torch.randn(shape, device="cuda")
            with cs.Recorder(attention, "flash_bwd_dq", limit=1) as rec:
                (model(x, t).float() * r).sum().backward()
            calls.append((dtype_name, rec.calls[0][0]))
            del model
    torch.cuda.synchronize()
    return calls


def flash_bwd_case(lib, dtype_name, args, reps):
    """The parent's flash_bwd_dq / flash_bwd_dkv against this tree's on
    one recorded input: both held to the plain backward at chip_smoke.py's
    rule, each kernel timed A B B A. With ``reps`` 0: the parent's dq,
    dk, dv and D alone."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import _build, attention

    q, k, v, out, lse, do, scale = args
    BH, T, _ = q.shape
    bf16 = int(q.dtype == torch.bfloat16)
    stream = _build.stream_ptr(q)
    c2, c2l = scale * scale, scale * scale * math.log2(math.e)

    dq_p, dk_p, dv_p = (torch.empty_like(q) for _ in range(3))
    D_p = torch.empty_like(lse)

    def parent_dq():
        _build.check(lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), D_p.data_ptr(), dq_p.data_ptr(),
            *lib.split_args, BH, T, *hd_args(lib, q), c2l, c2, bf16,
            stream), "parent flash_bwd_dq")

    def parent_dkv():
        _build.check(lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D_p.data_ptr(), dk_p.data_ptr(), dv_p.data_ptr(),
            *lib.split_args, BH, T, *hd_args(lib, q), c2l, c2, bf16,
            stream), "parent flash_bwd_dkv")

    parent_dq()
    parent_dkv()
    if not reps:   # the outputs alone
        return dq_p, dk_p, dv_p, D_p
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale)
    fwd_in = ((out, lse) if bf16 else
              attention.attention_lse_plain(q, k, v, scale))
    want = attention.attention_bwd_plain(q, k, v, *fwd_in, do, scale)
    rel, share = cs.BWD_TOL[dtype_name]

    def over(grads):
        return [float(((g.float() - w.float()).abs()
                       / (share * float(w.float().abs().max())
                          + rel * w.float().abs())).max())
                for g, w in zip(grads, want)]

    new_over, parent_over = over((dq, dk, dv)), over((dq_p, dk_p, dv_p))
    torch.cuda.synchronize()
    gaps = [float((a.float() - b.float()).abs().max())
            for a, b in ((dq, dq_p), (dk, dk_p), (dv, dv_p), (D, D_p))]
    t_dq = abba(parent_dq, lambda: attention.flash_bwd_dq(
        q, k, v, out, lse, do, scale), reps)
    t_dkv = abba(parent_dkv, lambda: attention.flash_bwd_dkv(
        q, k, v, lse, do, D, scale), reps)
    res = dict(kernel="flash_bwd", dtype=dtype_name, BH=BH, T=T,
               over=new_over, parent_over=parent_over, parent_gaps=gaps,
               dq_parent_ms=t_dq["parent"],
               dq_new_ms=t_dq["new"], dkv_parent_ms=t_dkv["parent"],
               dkv_new_ms=t_dkv["new"])
    cs.log(f"ab: flash_bwd [{BH},{T},64] {dtype_name}: dq/dk/dv at "
           f"{new_over[0]:.3f} / {new_over[1]:.3f} / {new_over[2]:.3f} of "
           f"chip_smoke's rule (parent {parent_over[0]:.3f} / "
           f"{parent_over[1]:.3f} / {parent_over[2]:.3f}); parent − new "
           f"max |diff| dq/dk/dv/D {gaps[0]:.3e} / {gaps[1]:.3e} / "
           f"{gaps[2]:.3e} / {gaps[3]:.3e}; device ms dq "
           f"parent {t_dq['parent'][0]:.4f}, new {t_dq['new'][0]:.4f}, new "
           f"{t_dq['new'][1]:.4f}, parent {t_dq['parent'][1]:.4f}; dkv "
           f"parent {t_dkv['parent'][0]:.4f}, new {t_dkv['new'][0]:.4f}, "
           f"new {t_dkv['new'][1]:.4f}, parent {t_dkv['parent'][1]:.4f}")
    if max(new_over) > 1.0:
        raise AssertionError(f"flash_bwd {dtype_name} T={T}: over "
                             f"{new_over}, distance from the parent {gaps}")
    return res


def parent_forward(lib, q, k, v, c2l):
    """The parent's forward kernel of q's dtype: (out, lse)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build

    BH, T, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    entry = "flash_attn_launch"
    if q.dtype == torch.float32:
        entry = "flash_attn_f32_launch"
        if lib.f32_takes_split:
            split = torch.empty((6, BH, T, q.shape[2]), dtype=torch.bfloat16,
                                device=q.device)
            ptrs.append(split.data_ptr())
    _build.check(getattr(lib, entry)(*ptrs, out.data_ptr(), lse.data_ptr(),
                                     BH, T, *hd_args(lib, q), c2l,
                                     _build.stream_ptr(q)),
                 "parent " + entry)
    return out, lse


# the other head dims the parent's and this tree's kernels both run (the
# head-dim-64 ones are the recorded cases)
AB_HEAD_DIMS = (8, 16, 32)


def flash_head_dim_case(lib, hd, dtype_name, seed):
    """The parent's forward and backward kernels against this tree's at
    head dim ``hd`` on seeded N(0, 1) q, k, v, dO [4, 4097, hd] (one live
    row in the last tile), the backward on this tree's out and lse: the
    parent − new max |diff| of out, lse, dq, dk, dv and D (--same-bits
    wants every one 0)."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    gen = torch.Generator(device="cuda").manual_seed(seed + hd)
    q, k, v, do = (torch.randn((4, 4097, hd), generator=gen,
                               device="cuda").to(getattr(torch, dtype_name))
                   for _ in range(4))
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    out_p, lse_p = parent_forward(lib, q, k, v,
                                  scale * scale * math.log2(math.e))
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale)
    dq_p, dk_p, dv_p, D_p = flash_bwd_case(
        lib, dtype_name, (q, k, v, out, lse, do, scale), 0)
    torch.cuda.synchronize()
    gaps = [float((a.float() - b.float()).abs().max())
            for a, b in ((dq, dq_p), (dk, dk_p), (dv, dv_p), (D, D_p))]
    res = dict(kernel="flash_hd", dtype=dtype_name, hd=hd, T=4097,
               out_gap=float((out - out_p).abs().max()),
               lse_gap=float((lse - lse_p).abs().max()), parent_gaps=gaps)
    cs.log(f"ab: flash [4,4097,{hd}] {dtype_name}: parent − new max |diff| "
           f"out {res['out_gap']:.3e}, lse {res['lse_gap']:.3e}, dq/dk/dv/D "
           + " / ".join(f"{g:.3e}" for g in gaps))
    return res


def flash_fwd_case(lib, dtype_name, args, reps):
    """The parent's forward against this tree's on one recorded q, k, v:
    both held to the plain forward (out at chip_smoke.py's rule, the lse
    by its lse_check), their largest distance (bf16: must be 0), and each
    timed A B B A (the f32 kernel with its split pre-pass), with SDPA
    between the two halves."""
    import math

    import torch
    import torch.nn.functional as F
    from ipdm_tpu_torch.ops.cuda import attention

    q, k, v = args[:3]
    scale = args[-1]
    BH, T, _ = q.shape
    c2l = scale * scale * math.log2(math.e)
    out_p, lse_p = parent_forward(lib, q, k, v, c2l)
    out_n, lse_n = attention._forward(q, k, v, scale, with_lse=True)
    want = attention.attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    rtol, atol = cs.flash_tol(want, dtype_name)

    def over(out):
        return float(((out.float() - want.float()).abs()
                      / (atol + rtol * want.float().abs())).max())

    new_over, parent_over = over(out_n), over(out_p)
    del want
    lse_over = cs.lse_check(lse_n, q, k, scale, dtype_name)[0]
    parent_lse_over = cs.lse_check(lse_p, q, k, scale, dtype_name)[0]
    gap = float((out_p.float() - out_n.float()).abs().max())
    lse_gap = float((lse_p - lse_n).abs().max())
    q4, k4, v4 = (t_.view(1, BH, T, 64) for t_ in (q, k, v))
    t = abba(lambda: parent_forward(lib, q, k, v, c2l),
             lambda: attention.flash_attention(q, k, v, scale), reps)
    sdpa = spin_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, scale=scale * scale), reps)
    res = dict(kernel="flash_fwd", dtype=dtype_name, BH=BH, T=T,
               over=new_over, parent_over=parent_over, lse_over=lse_over,
               parent_lse_over=parent_lse_over, out_gap=gap, lse_gap=lse_gap,
               parent_ms=t["parent"], new_ms=t["new"], sdpa_ms=sdpa)
    cs.log(f"ab: flash_fwd [{BH},{T},64] {dtype_name}: out at {new_over:.4f}"
           f" of chip_smoke's rule (parent {parent_over:.4f}), lse at "
           f"{lse_over:.4f} of lse_check's bound (parent "
           f"{parent_lse_over:.4f}); parent − new max |diff| out {gap:.3e}, "
           f"lse {lse_gap:.3e}; device ms parent {t['parent'][0]:.4f}, new "
           f"{t['new'][0]:.4f}, new {t['new'][1]:.4f}, parent "
           f"{t['parent'][1]:.4f}; SDPA {sdpa:.4f}")
    if new_over > 1.0 or (dtype_name == "bfloat16" and (gap or lse_gap)):
        raise AssertionError(f"flash_fwd {dtype_name} T={T}: over "
                             f"{new_over}, distance from the parent {gap} / "
                             f"{lse_gap}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    groups = ("deposit", "anterp", "flash_fwd", "flash_bwd")
    ap.add_argument("--kernels", nargs="+", choices=groups, default=groups)
    ap.add_argument("--same-bits", action="store_true",
                    help="exit 1 unless every output of every kernel is "
                         "bit-equal to the parent's")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    from ipdm_tpu_torch.ops.cuda import _build

    smi = cs.nvidia_smi_line()
    cs.log(f"ab: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.library()
    lib = build_parent(a.parent.resolve())
    res = []
    if {"deposit", "anterp"} & set(a.kernels):
        calls = record_inputs(a.seed)
        with torch.inference_mode():
            for args, kw in calls["d6"] if "deposit" in a.kernels else ():
                res.append(deposit_case(lib, "fp_plane_deposit",
                                        "fp_deposit_launch", args, kw,
                                        a.reps))
            for args, kw in calls["d8"] if "deposit" in a.kernels else ():
                res.append(deposit_case(lib, "fp_shift_deposit_batched",
                                        "fp_shift_deposit_batched_launch",
                                        args, kw, a.reps))
                res.append(deposit_case(lib, "fp_shift_deposit",
                                        "fp_shift_deposit_launch", args, kw,
                                        a.reps, single=True))
            for label in (("a_resample", "a_plan", "a_fp")
                          if "anterp" in a.kernels else ()):
                for args, kw in calls[label]:
                    res.append(anterp_case(lib, label[2:], args, kw, a.reps))
    if {"flash_fwd", "flash_bwd"} & set(a.kernels):
        for dtype_name, args in record_flash_bwd(a.seed):
            with torch.no_grad():
                if "flash_fwd" in a.kernels:
                    res.append(flash_fwd_case(lib, dtype_name, args, a.reps))
                if "flash_bwd" in a.kernels:
                    res.append(flash_bwd_case(lib, dtype_name, args,
                                              a.reps))
        if lib.takes_hd:
            with torch.no_grad():
                for hd in AB_HEAD_DIMS:
                    for dtype_name in ("bfloat16", "float32"):
                        res.append(flash_head_dim_case(lib, hd, dtype_name,
                                                       a.seed))
    line = json.dumps({"device": smi, "ab": res})
    if a.out:
        os.makedirs(a.out.parent, exist_ok=True)
        a.out.write_text(line + "\n")
    differ = [(r["kernel"], r.get("dtype"), r.get("T")) for r in res
              if any(r.get(k) for k in ("parent_gap", "out_gap", "lse_gap"))
              or any(r.get("parent_gaps", ()))]
    if a.same_bits:
        cs.log(f"ab: outputs bit-equal to the parent's: "
               + ("all" if not differ else f"not {differ}"))
    print(line)
    return 1 if a.same_bits and differ else 0


if __name__ == "__main__":
    sys.exit(main())

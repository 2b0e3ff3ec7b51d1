#!/usr/bin/env python3
"""Time the port's deposit, anterp_taps and flash-attention kernels
against a parent commit's, on one NVIDIA GPU, in one process.

    python3 scripts/torch_kernels_ab.py --parent DIR [--reps 20] [--out F]
        [--kernels deposit anterp flash_fwd flash_bwd] [--same-bits]
    python3 scripts/torch_kernels_ab.py --narrow-variants NWG,KT [...]
    python3 scripts/torch_kernels_ab.py --narrow-bwd-variants NWG,KT [...]
    python3 scripts/torch_kernels_ab.py --wide-variants \
        SLICE,NWG,STAGES_F32,STAGES_BF16,CREGS [...]
    python3 scripts/torch_kernels_ab.py --wide-bwd-variants \
        DQ_SLICE,DKV_SLICE,CREGS [...]

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
  backward against this tree's at head dims 8, 16, 32 and 128 (and 192
  and 256 on the wide bodies, where the parent has them), both dtypes,
  on seeded inputs at T = 4097: the largest parent − new distance of
  every output, and the forward timed A B B A. Where this tree's f32
  forward at head dim 8 is the narrow body (csrc/flash_narrow.cu) and
  the parent's is not, that forward's distance is printed, not required
  to be 0 (its backward runs on this tree's out and lse in both); where
  this tree's f32 backward at head dim 8 is the narrow body
  (csrc/flash_narrow_bwd.cu) and the parent's is not, its dq, dk and dv
  are held, the parent's beside them, to the f64 plain backward at
  flash_long's rule instead of to the parent's bits (D still must be
  bit-equal);
* the forward at head dims 128-512 (:data:`WIDE_FWD_SHAPES`: 128, 192,
  256, 320 and 512 at T = 4097 and 7125, 256 at 16 384), both dtypes,
  on seeded N(0, 1) inputs: the parent's and this tree's, each held to
  the plain forward (out at chip_smoke.py's rule, the lse by lse_check),
  their distance (not required to be 0 where this tree's forward runs
  the wide body of _build.FLASH_FWD_WIDE_FROM and the parent's does
  not), each timed A B B A beside SDPA and the bound;
* the backward at head dims 128-512 (:data:`WIDE_BWD_SHAPES`), on seeded
  N(0, 1) q, k, v, dO with this tree's forward's out and lse: the
  parent's dq / dkv and this tree's, each held to the plain backward (f32:
  the f64 plain backward at flash_long's rule; bf16: chip_smoke.py's bf16
  rule on the same out and lse), their distance, each kernel timed A B B
  A beside SDPA's backward alone and the bound;
* ``wide_train``: the mc-256 f32 train step (make_train_step, remat, B =
  1) of each UNet with the parent's backward kernels and this tree's,
  parent, new, new, parent: s/step and the flash backward's device ms a
  step (chip_smoke.py BwdTimer);
* ``wide_slice``: chip_smoke.py's wide-phase slice at mc 256 (the f32 ART
  slice) with the parent's forward and this tree's, parent, new, new,
  parent: s/slice and the forward's device ms in a profiled slice; and on
  the wide phase's recorded forward inputs at each width, the parent's
  forward and this tree's held to the plain forward;
* the f32 forward and backward at head dim 8 (4 heads) at T = 16 384 and
  114 000 on chip_smoke.py flash_long's seeded inputs: the parent's and
  this tree's, each held to the f64 plain version over query blocks (out
  at chip_smoke.py's f32 rule, the lse at flash_long's bound, dq, dk, dv
  at its f32 rule + witness), each kernel timed A B B A;
* times the parent's kernel (launched bare) and this tree's (through
  its wrapper, with the host bounds the main path passes), back to back
  with the stream held by a spin kernel (device time), in the order
  parent, new, new, parent; and this tree's wrapper alone, CUDA events
  around back-to-back calls (host time included where it is longer).

With ``--narrow-variants`` (and no parent) the script instead builds
``csrc/flash_narrow.cu`` at each given (warpgroups a CTA, 64-key
sub-tiles a key tile) pair (its IPDM_NARROW_NWG / IPDM_NARROW_KT), each
source with a C shim over its entry in an nvcc process of its own, and
at T = 16 384 and 114 000 holds each to the f64 plain forward (as
above) and times it against this tree's build (the wrapper) A B B A.
``--narrow-bwd-variants`` does the same for ``csrc/flash_narrow_bwd.cu``
at each (warpgroups a CTA, 64-row sub-tiles a ring tile) pair
(IPDM_NARROW_BWD_NWG / _KT): its dq and its dkv
each held to the f64 plain backward and timed against this tree's build
of the same entry (``flash_narrow_bwd_launch``), A B B A.

With ``--wide-bwd-variants`` it builds ``csrc/flash_bwd.cu`` at each given
set of the wide backward's build constants (IPDM_WBWD_DQ_SLICE,
_DKV_SLICE, _CREGS; registers and spills logged) and holds
each variant's dq and dkv, and this tree's build's, to the plain backward
and times them against this tree's build, A B B A, at
:data:`WIDE_BWD_VARIANT_SHAPES` in both dtypes.

With ``--wide-variants`` the script builds ``csrc/flash_attn.cu`` at each
given set of the wide forward's build constants (IPDM_WIDE_SLICE, _NWG,
_STAGES_F32, _STAGES_BF16, _CREGS; registers and spills logged) and holds
each to the plain forward and times it against this tree's build, A B B
A, at :data:`WIDE_VARIANT_SHAPES` in both dtypes.

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


def parent_takes_wide(parent: Path) -> bool:
    """Whether the parent's flash entries run head dims above 128 (the
    wide bodies)."""
    return "FLASH_WIDE_CHUNK" in (parent / "ipdm_tpu_torch" / "ops" / "cuda"
                                  / "attention.py").read_text()


def parent_narrow(parent: Path) -> bool:
    """Whether the parent's f32 forward at head dim 8 is the narrow body
    (its [5, BH, T, 16] scratch)."""
    return (parent / "ipdm_tpu_torch" / "csrc" / "flash_narrow.cu").exists()


def parent_narrow_bwd(parent: Path) -> bool:
    """Whether the parent's f32 backward at head dim 8 is the narrow body
    (csrc/flash_narrow_bwd.cu)."""
    return (parent / "ipdm_tpu_torch" / "csrc"
            / "flash_narrow_bwd.cu").exists()


def parent_fwd_wide_from(parent: Path) -> bool:
    """Whether the parent's forward runs the wide body of this design
    from a head dim on (``_build.FLASH_FWD_WIDE_FROM``): one CTA holding
    up to 256 columns of O, S built once per key tile."""
    return "FLASH_FWD_WIDE_FROM" in (parent / "ipdm_tpu_torch" / "ops"
                                     / "cuda" / "_build.py").read_text()


def parent_bwd_wide_from(parent: Path) -> bool:
    """Whether the parent's backward runs the wide body of this design
    from a head dim on (``_build.FLASH_BWD_WIDE_FROM``): one CTA holding
    128 rows and up to 256 columns of dQ (128 of dK and dV), S and dP
    built once per ring tile."""
    return "FLASH_BWD_WIDE_FROM" in (parent / "ipdm_tpu_torch" / "ops"
                                     / "cuda" / "_build.py").read_text()


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
            if (name == "flash_bwd_dkv_launch"
                    and parent_bwd_wide_from(parent)):
                argtypes = argtypes[:9] + [I] + argtypes[9:]   # ready
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.f32_takes_split = parent_f32_takes_split(parent)
    lib.takes_hd = parent_takes_hd(parent)
    lib.bwd_split = parent_bwd_takes_split(parent)
    lib.wide = parent_takes_wide(parent)
    lib.narrow = parent_narrow(parent)
    lib.narrow_bwd = parent_narrow_bwd(parent)
    lib.fwd_wide_from = parent_fwd_wide_from(parent)
    lib.bwd_wide_from = parent_bwd_wide_from(parent)
    return lib


def split_args(lib, q) -> tuple:
    """The split scratch argument of the parent's backward entries (none
    where they take none): a [8, BH, T, hd] bf16 tensor for f32 at head
    dims 128 and above (hi and lo of q, k, v and dO), the narrow
    backward's scratch (attention._bwd_split) for f32 at head dim 8 where
    the parent has that body, else null."""
    import torch
    if not lib.bwd_split:
        return ()
    BH, T, hd = q.shape
    if q.dtype != torch.float32 or 8 < hd < 128 or (hd == 8
                                                   and not lib.narrow_bwd):
        return (None,)
    from ipdm_tpu_torch.ops.cuda import attention
    split = attention._bwd_split(q, hd)
    lib.keep = split   # alive until the next case's launches
    return (split.data_ptr(),)


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


def parent_bwd(lib, args):
    """The parent's flash_bwd_dq and flash_bwd_dkv on args (q, k, v, out,
    lse, do, scale), each launched once: ((dq, dk, dv, D), a launcher of
    each)."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import _build

    q, k, v, out, lse, do, scale = args
    BH, T, _ = q.shape
    bf16 = int(q.dtype == torch.bfloat16)
    stream = _build.stream_ptr(q)
    c2, c2l = scale * scale, scale * scale * math.log2(math.e)
    dq_p, dk_p, dv_p = (torch.empty_like(q) for _ in range(3))
    D_p = torch.empty_like(lse)
    split = split_args(lib, q)

    def parent_dq():
        _build.check(lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), D_p.data_ptr(), dq_p.data_ptr(),
            *split, BH, T, *hd_args(lib, q), c2l, c2, bf16,
            stream), "parent flash_bwd_dq")

    def parent_dkv():
        _build.check(lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D_p.data_ptr(), dk_p.data_ptr(), dv_p.data_ptr(),
            *split, *((0,) if lib.bwd_wide_from else ()), BH, T,
            *hd_args(lib, q), c2l, c2, bf16, stream), "parent flash_bwd_dkv")

    parent_dq()
    parent_dkv()
    return (dq_p, dk_p, dv_p, D_p), parent_dq, parent_dkv


def flash_bwd_case(lib, dtype_name, args, reps):
    """The parent's flash_bwd_dq / flash_bwd_dkv against this tree's on
    one recorded input: both held to the plain backward at chip_smoke.py's
    rule, each kernel timed A B B A. With ``reps`` 0: the parent's dq,
    dk, dv and D alone."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    q, k, v, out, lse, do, scale = args
    BH, T, _ = q.shape
    (dq_p, dk_p, dv_p, D_p), parent_dq, parent_dkv = parent_bwd(lib, args)
    if not reps:   # the outputs alone
        return dq_p, dk_p, dv_p, D_p
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale)
    fwd_in = ((out, lse) if q.dtype == torch.bfloat16 else
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
            hd = q.shape[2]
            shape = ((5, BH, T, 16) if hd == 8 and lib.narrow else
                     (6, BH, T, hd))
            split = torch.empty(shape, dtype=torch.bfloat16, device=q.device)
            ptrs.append(split.data_ptr())
    _build.check(getattr(lib, entry)(*ptrs, out.data_ptr(), lse.data_ptr(),
                                     BH, T, *hd_args(lib, q), c2l,
                                     _build.stream_ptr(q)),
                 "parent " + entry)
    return out, lse


# the other head dims the parent's and this tree's kernels both run (the
# head-dim-64 ones are the recorded cases); AB_WIDE_HEAD_DIMS where the
# parent has the wide bodies
AB_HEAD_DIMS = (8, 16, 32, 128)
AB_WIDE_HEAD_DIMS = (192, 256)


def narrow_is_new(lib, hd, dtype_name) -> bool:
    """Whether this tree's forward at (hd, dtype) is the narrow body and
    the parent's is not (their out and lse then differ by design)."""
    from ipdm_tpu_torch.ops.cuda import _build
    return (hd == 8 and dtype_name == "float32" and not lib.narrow
            and (_build.SRC_DIR / "flash_narrow.cu").exists())


def narrow_bwd_is_new(lib, hd, dtype_name) -> bool:
    """Whether this tree's backward at (hd, dtype) is the narrow body and
    the parent's is not (their dq, dk and dv then differ by design; D is
    the same kernel's)."""
    from ipdm_tpu_torch.ops.cuda import _build
    return (hd == 8 and dtype_name == "float32" and not lib.narrow_bwd
            and (_build.SRC_DIR / "flash_narrow_bwd.cu").exists())


def wide_bwd_is_new(lib, hd, dtype_name) -> bool:
    """Whether this tree's backward at (``hd``, dtype) runs the wide body
    of csrc/flash_bwd.cu (_build.FLASH_BWD_WIDE_FROM) and the parent's
    does not run that body (their dq, dk and dv then differ by design, or
    may; D is the same kernel's)."""
    from ipdm_tpu_torch.ops.cuda import _build
    return (_build.flash_counter("flash_bwd_dq", hd)
            == "flash_bwd_dq_wide" and not lib.bwd_wide_from)


def bwd_rule_over(dtype_name, grads, args, ref=None) -> list:
    """dq, dk, dv over their rule: f32 against the f64 plain backward
    ``ref`` at flash_long's rule (:func:`bwd_over`); bf16 against the
    plain backward on args' (q, k, v, out, lse, do, scale) out and lse at
    chip_smoke.py's bf16 rule."""
    if dtype_name == "float32":
        return bwd_over(grads, ref)
    from ipdm_tpu_torch.ops.cuda import attention
    want = attention.attention_bwd_plain(*args)
    rel, share = cs.BWD_TOL[dtype_name]
    return [float(((g.float() - w.float()).abs()
                   / (share * float(w.float().abs().max())
                      + rel * w.float().abs())).max())
            for g, w in zip(grads, want)]


def bwd_over(grads, ref) -> list:
    """dq, dk, dv over chip_smoke.py flash_long's rule against the f64
    plain backward ``ref`` (:func:`chip_smoke._plain_long`): the f32 rule
    plus 2⁻²⁰·Σ|terms before the cancellation|."""
    rel, share = cs.BWD_TOL["float32"]
    res = []
    for name, g in zip(("dq", "dk", "dv"), grads):
        w = ref[name]
        rule = (share * float(w.abs().max()) + rel * w.abs()
                + cs.RAGGED_F32_EPS * ref["z" + name[1]])
        res.append(float(((g.double() - w).abs() / rule).max()))
    return res


def flash_head_dim_case(lib, hd, dtype_name, seed, reps):
    """The parent's forward and backward kernels against this tree's at
    head dim ``hd`` on seeded N(0, 1) q, k, v, dO [4, 4097, hd] (one live
    row in the last tile), the backward on this tree's out and lse: the
    parent − new max |diff| of out, lse, dq, dk, dv and D (--same-bits
    wants every one 0, but the forward's where :func:`narrow_is_new` and
    dq, dk, dv where :func:`narrow_bwd_is_new`: those are held, the
    parent's beside them, to the f64 plain backward at flash_long's rule
    instead), and the forwards' device ms A B B A."""
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
    bwd_new = (narrow_bwd_is_new(lib, hd, dtype_name)
               or wide_bwd_is_new(lib, hd, dtype_name))
    over = {}
    if bwd_new:
        args = (q, k, v, out, lse, do, scale)
        ref = (cs._plain_long(q, k, v, do, scale)
               if dtype_name == "float32" else None)
        over = dict(bwd_over=bwd_rule_over(dtype_name, (dq, dk, dv), args,
                                           ref),
                    parent_bwd_over=bwd_rule_over(
                        dtype_name, (dq_p, dk_p, dv_p), args, ref))
        del ref
    c2l = scale * scale * math.log2(math.e)
    t = abba(lambda: parent_forward(lib, q, k, v, c2l),
             lambda: attention._forward(q, k, v, scale, with_lse=True), reps)
    res = dict(kernel="flash_hd", dtype=dtype_name, hd=hd, T=4097,
               out_gap=float((out - out_p).abs().max()),
               lse_gap=float((lse - lse_p).abs().max()), parent_gaps=gaps,
               fwd_body_changed=(narrow_is_new(lib, hd, dtype_name)
                                 or wide_fwd_is_new(lib, hd, dtype_name)),
               bwd_body_changed=bwd_new, **over,
               fwd_parent_ms=t["parent"], fwd_new_ms=t["new"])
    cs.log(f"ab: flash [4,4097,{hd}] {dtype_name}: parent − new max |diff| "
           f"out {res['out_gap']:.3e}, lse {res['lse_gap']:.3e}"
           + (" (the narrow or wide body against the parent's)"
              if res["fwd_body_changed"] else "")
           + ", dq/dk/dv/D " + " / ".join(f"{g:.3e}" for g in gaps)
           + (" (dq/dk/dv: the narrow or wide backward against the "
              "parent's; against the plain backward at its rule "
              + " / ".join(f"{x:.4f}" for x in over["bwd_over"])
              + ", parent " + " / ".join(f"{x:.4f}"
                                         for x in over["parent_bwd_over"])
              + ")" if bwd_new else "")
           + f"; forward device ms parent {t['parent'][0]:.4f}, new "
           f"{t['new'][0]:.4f}, new {t['new'][1]:.4f}, parent "
           f"{t['parent'][1]:.4f}")
    if bwd_new and max(over["bwd_over"]) > 1.0:
        raise AssertionError(f"flash bwd hd {hd} {dtype_name} T=4097: "
                             f"over {over}")
    return res


# the ablation UNets' middle block: 4 heads of head dim 8 over 128² and
# 500×228 tokens
NARROW_T = (16384, 114000)


def narrow_case(lib, T, seed, reps):
    """The f32 forward at head dim 8 on seeded q, k (sd 1) and v (head h:
    mean h + 1) [4, T, 8], chip_smoke.py flash_long's inputs: the
    parent's and this tree's, each held to the f64 plain forward over
    query blocks (out at the f32 rule, the lse within
    2⁻¹⁶·R + T·2⁻²³), their distance, and device ms A B B A."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    q, k, v, _, scale = long_inputs(T, seed)
    BH, _, hd = q.shape
    c2l = scale * scale * math.log2(math.e)
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    out_p, lse_p = parent_forward(lib, q, k, v, c2l)
    ref = cs._plain_long(q, k, v, torch.zeros_like(q), scale)
    torch.cuda.synchronize()
    rtol, atol = cs.flash_tol(ref["out"], "float32")
    ltol = cs.LSE_EPS["float32"] * ref["R"] + T * 2.0 ** -23

    def over(o, l_):
        return (float(((o.double() - ref["out"]).abs()
                       / (atol + rtol * ref["out"].abs())).max()),
                float(((l_.double() - ref["lse"]).abs() / ltol).max()))

    new_over, parent_over = over(out, lse), over(out_p, lse_p)
    del ref
    t = abba(lambda: parent_forward(lib, q, k, v, c2l),
             lambda: attention._forward(q, k, v, scale, with_lse=True), reps)
    res = dict(kernel="flash_narrow", dtype="float32", BH=BH, T=T, hd=hd,
               over=new_over, parent_over=parent_over,
               fwd_body_changed=narrow_is_new(lib, hd, "float32"),
               out_gap=float((out - out_p).abs().max()),
               lse_gap=float((lse - lse_p).abs().max()),
               parent_ms=t["parent"], new_ms=t["new"])
    faster = max(t["new"]) < min(t["parent"])
    cs.log(f"ab: flash f32 [{BH},{T},{hd}] (f64 plain over query blocks): "
           f"out / lse at {new_over[0]:.4f} / {new_over[1]:.4f} of the f32 "
           f"rule (parent {parent_over[0]:.4f} / {parent_over[1]:.4f}); "
           f"parent − new max |diff| out {res['out_gap']:.3e}, lse "
           f"{res['lse_gap']:.3e}; device ms parent {t['parent'][0]:.4f}, "
           f"new {t['new'][0]:.4f}, new {t['new'][1]:.4f}, parent "
           f"{t['parent'][1]:.4f} (new "
           f"{'faster' if faster else 'not faster'})")
    if max(new_over) > 1.0:
        raise AssertionError(f"flash f32 hd 8 T={T}: over {new_over}")
    return res


def long_inputs(T, seed):
    """chip_smoke.py flash_long's inputs at head dim 8: seeded q, k, dO
    (sd 1) and v (head h: mean h + 1), [4, T, 8] f32, and the scale."""
    import math

    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + T)
    q, k = (torch.randn((4, T, 8), generator=gen, device="cuda")
            for _ in range(2))
    v = torch.randn((4, T, 8), generator=gen, device="cuda") + torch.arange(
        1.0, 5, device="cuda").view(4, 1, 1)
    do = torch.randn((4, T, 8), generator=gen, device="cuda")
    return q, k, v, do, 1.0 / math.sqrt(math.sqrt(8))


def narrow_bwd_case(lib, T, seed, reps):
    """The f32 backward at head dim 8 (4 heads) on :func:`long_inputs`,
    from this tree's forward's out and lse: the parent's dq / dkv and this
    tree's, each held to the f64 plain backward over query blocks at
    flash_long's rule (:func:`bwd_over`), D's distance, and each kernel's
    device ms A B B A."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    q, k, v, do, scale = long_inputs(T, seed)
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    args = (q, k, v, out, lse, do, scale)
    (dq_p, dk_p, dv_p, D_p), parent_dq, parent_dkv = parent_bwd(lib, args)
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale)
    ref = cs._plain_long(q, k, v, do, scale)
    torch.cuda.synchronize()
    new_over = bwd_over((dq, dk, dv), ref)
    parent_over = bwd_over((dq_p, dk_p, dv_p), ref)
    del ref
    t_dq = abba(parent_dq, lambda: attention.flash_bwd_dq(
        q, k, v, out, lse, do, scale), reps)
    t_dkv = abba(parent_dkv, lambda: attention.flash_bwd_dkv(
        q, k, v, lse, do, D, scale), reps)
    res = dict(kernel="flash_narrow_bwd", dtype="float32", BH=4, T=T, hd=8,
               over=new_over, parent_over=parent_over,
               bwd_body_changed=narrow_bwd_is_new(lib, 8, "float32"),
               parent_gaps=[float((a - b).abs().max()) for a, b in
                            ((dq, dq_p), (dk, dk_p), (dv, dv_p), (D, D_p))],
               dq_parent_ms=t_dq["parent"], dq_new_ms=t_dq["new"],
               dkv_parent_ms=t_dkv["parent"], dkv_new_ms=t_dkv["new"])
    cs.log(f"ab: flash_bwd f32 [4,{T},8] (f64 plain over query blocks): "
           f"dq/dk/dv at " + " / ".join(f"{x:.4f}" for x in new_over)
           + " of flash_long's rule (parent "
           + " / ".join(f"{x:.4f}" for x in parent_over) + "); parent − new "
           "max |diff| dq/dk/dv/D " + " / ".join(
               f"{x:.3e}" for x in res["parent_gaps"])
           + f"; device ms dq parent {t_dq['parent'][0]:.4f}, new "
           f"{t_dq['new'][0]:.4f}, new {t_dq['new'][1]:.4f}, parent "
           f"{t_dq['parent'][1]:.4f}; dkv parent {t_dkv['parent'][0]:.4f}, "
           f"new {t_dkv['new'][0]:.4f}, new {t_dkv['new'][1]:.4f}, parent "
           f"{t_dkv['parent'][1]:.4f}")
    if max(new_over) > 1.0:
        raise AssertionError(f"flash bwd f32 hd 8 T={T}: over {new_over}")
    return res


def build_variants(src: str, kernel: str, defines: dict,
                   shim: str = "") -> dict:
    """csrc/``src`` built at each variant's -D ``defines`` {key: {name:
    value}} with this tree's nvcc flags, with the C ``shim`` source beside
    it where given (one nvcc process each, all at once; ptxas's registers
    and spills of every kernel whose name holds ``kernel`` logged): {key:
    CDLL}."""
    from ipdm_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="variants-", dir=_build.BUILD_DIR))
    extra = []
    if shim:
        (out / "shim.cu").write_text(shim)
        extra = [str(out / "shim.cu")]
    nvcc = _build._nvcc()
    procs = {}
    for key, defs in defines.items():
        lib = out / ("lib_" + "_".join(str(x) for x in key) + ".so")
        procs[key] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v",
             *[f"-D{n}={v}" for n, v in defs.items()], "-I",
             str(_build.SRC_DIR), "-shared", str(_build.SRC_DIR / src),
             *extra, "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {src} at {key}:\n{log.decode()}")
        lines = log.decode(errors="replace").splitlines()
        for i, ln in enumerate(lines):   # ptxas: the main kernels' registers
            if kernel in ln and "Compiling" in ln:
                name = ln.split("'")[1]
                at = name.find(kernel)
                cs.log(f"ab: {src} build {key}: "
                       f"{name[at:at + len(kernel) + 8]}: "
                       + "; ".join(x.strip() for x in lines[i + 1:i + 4]
                                   if "registers" in x or "spill" in x))
        libs[key] = ctypes.CDLL(str(path))
    return libs


def narrow_bwd_variant_case(libs, T, seed, reps):
    """Each variant build of the head-dim-8 f32 backward (flash_narrow_bwd
    .cu's entry) on :func:`long_inputs` at T, with this tree's forward's
    out and lse and its dq's D: held to the f64 plain backward at
    flash_long's rule (:func:`bwd_over`), and its dq and its dkv each timed
    against this tree's build of the same entry, A B B A."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import _build, attention

    q, k, v, do, scale = long_inputs(T, seed)
    BH = q.shape[0]
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    _, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    split = attention._bwd_split(q, 8)
    c2, c2l = scale * scale, scale * scale * math.log2(math.e)
    ref = cs._plain_long(q, k, v, do, scale)

    def entry(lib, dkv, o0, o1):
        def run():
            _build.check(lib.flash_narrow_bwd_launch(
                dkv, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), D.data_ptr(), o0.data_ptr(),
                None if o1 is None else o1.data_ptr(), split.data_ptr(), BH,
                T, c2l, c2, 0, _build.stream_ptr(q)), "flash_narrow_bwd")
        return run

    shipped = _build.library()
    s_dq = entry(shipped, 0, torch.empty_like(q), None)
    s_dkv = entry(shipped, 1, torch.empty_like(q), torch.empty_like(q))
    res = []
    for key, lib in libs.items():
        lib.flash_narrow_bwd_launch.argtypes = _build.SIGNATURES[
            "flash_narrow_bwd_launch"]
        lib.flash_narrow_bwd_launch.restype = ctypes.c_int
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        v_dq, v_dkv = entry(lib, 0, dq, None), entry(lib, 1, dk, dv)
        v_dq()
        v_dkv()
        torch.cuda.synchronize()
        ov = bwd_over((dq, dk, dv), ref)
        t_dq = abba(s_dq, v_dq, reps)
        t_dkv = abba(s_dkv, v_dkv, reps)
        r = dict(kernel="flash_narrow_bwd_variant", T=T, variant=list(key),
                 over=ov, dq_shipped_ms=t_dq["parent"],
                 dq_variant_ms=t_dq["new"], dkv_shipped_ms=t_dkv["parent"],
                 dkv_variant_ms=t_dkv["new"])
        cs.log(f"ab: flash_bwd f32 [{BH},{T},8] narrow build (NWG, KT) = "
               f"{key}: dq/dk/dv at "
               + " / ".join(f"{x:.4f}" for x in ov)
               + f" of flash_long's rule; device ms dq shipped "
               f"{t_dq['parent'][0]:.4f}, variant {t_dq['new'][0]:.4f}, "
               f"variant {t_dq['new'][1]:.4f}, shipped "
               f"{t_dq['parent'][1]:.4f}; dkv shipped "
               f"{t_dkv['parent'][0]:.4f}, variant {t_dkv['new'][0]:.4f}, "
               f"variant {t_dkv['new'][1]:.4f}, shipped "
               f"{t_dkv['parent'][1]:.4f}")
        if max(ov) > 1.0:
            raise AssertionError(f"narrow bwd {key} T={T}: over {ov}")
        res.append(r)
    del ref
    return res


# a C entry over flash_narrow.cu's (C++) one, for a variant build
NARROW_SHIM = """#include <cuda_runtime.h>
int flash_narrow_f32(const void*, const void*, const void*, void*, void*,
                     void*, int, int, float, cudaStream_t);
extern "C" int narrow_launch(const void* q, const void* k, const void* v,
                             void* split, void* out, void* lse, int BH,
                             int T, float scale_log2, cudaStream_t st) {
  return flash_narrow_f32(q, k, v, split, out, lse, BH, T, scale_log2, st);
}
"""


def build_narrow_variants(pairs) -> dict:
    """csrc/flash_narrow.cu built at each (warpgroups, sub-tiles) pair
    (:func:`build_variants`), each library's ``narrow_launch`` typed:
    {pair: CDLL}."""
    libs = build_variants("flash_narrow.cu", "flash_narrow_kernel", {
        (nwg, kt): dict(IPDM_NARROW_NWG=nwg, IPDM_NARROW_KT=kt)
        for nwg, kt in pairs}, NARROW_SHIM)
    for lib in libs.values():
        lib.narrow_launch.argtypes = [P, P, P, P, P, P, I, I, ctypes.c_float,
                                      P]
        lib.narrow_launch.restype = ctypes.c_int
    return libs


def narrow_variant_case(libs, T, seed, reps):
    """Each variant build of the head-dim-8 f32 forward on narrow_case's
    inputs at T: held to the f64 plain forward (out at the f32 rule, the
    lse at flash_long's bound), its distance from this tree's build, and
    both timed A B B A (this tree's through its wrapper)."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import _build, attention

    q, k, v, _, scale = long_inputs(T, seed)
    BH, _, hd = q.shape
    c2l = scale * scale * math.log2(math.e)
    split = torch.empty((5, BH, T, 16), dtype=torch.bfloat16, device="cuda")
    ref = cs._plain_long(q, k, v, torch.zeros_like(q), scale)
    rtol, atol = cs.flash_tol(ref["out"], "float32")
    ltol = cs.LSE_EPS["float32"] * ref["R"] + T * 2.0 ** -23

    def over(o, l_):
        return (float(((o.double() - ref["out"]).abs()
                       / (atol + rtol * ref["out"].abs())).max()),
                float(((l_.double() - ref["lse"]).abs() / ltol).max()))

    def shipped():
        return attention._forward(q, k, v, scale, with_lse=True)

    out, lse = shipped()
    res = []
    for (nwg, kt), lib in libs.items():
        o_v = torch.empty_like(q)
        l_v = torch.empty((BH, T), dtype=torch.float32, device="cuda")

        def variant(lib=lib, o_v=o_v, l_v=l_v):
            _build.check(lib.narrow_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), split.data_ptr(),
                o_v.data_ptr(), l_v.data_ptr(), BH, T, c2l,
                _build.stream_ptr(q)), f"flash_narrow ({nwg}, {kt})")

        variant()
        torch.cuda.synchronize()
        ov = over(o_v, l_v)
        t = abba(shipped, variant, reps)
        r = dict(kernel="flash_narrow_variant", T=T, nwg=nwg, kt=kt,
                 over=ov, out_gap=float((o_v - out).abs().max()),
                 lse_gap=float((l_v - lse).abs().max()),
                 shipped_ms=t["parent"], variant_ms=t["new"])
        cs.log(f"ab: flash f32 [{BH},{T},{hd}] narrow build at {nwg} "
               f"warpgroups, {kt} sub-tile(s) a key tile: out / lse at "
               f"{ov[0]:.4f} / {ov[1]:.4f} of the f32 rule; against the "
               f"shipped build max |diff| out {r['out_gap']:.3e}, lse "
               f"{r['lse_gap']:.3e}; device ms shipped {t['parent'][0]:.4f}"
               f", variant {t['new'][0]:.4f}, variant {t['new'][1]:.4f}, "
               f"shipped {t['parent'][1]:.4f}")
        if max(ov) > 1.0:
            raise AssertionError(f"narrow ({nwg}, {kt}) T={T}: over {ov}")
        res.append(r)
    return res


# the wide forward's shapes against the parent's forward: head dims 128
# (f32 on the wide body, bf16 on its instance: _build.FLASH_FWD_WIDE_FROM)
# to 512 in both dtypes at
# T = 4097 (one live key and query in the last tiles) and 7125 (the proj
# UNet's), and head dim 256 at the ablation UNets' 16 384
WIDE_FWD_SHAPES = tuple((hd, T) for hd in (128, 192, 256, 320, 512)
                        for T in (4097, 7125)) + ((256, 16384),)


def wide_fwd_is_new(lib, hd, dtype_name) -> bool:
    """Whether this tree's forward at (``hd``, dtype) runs the wide body
    of csrc/flash_attn.cu (_build.FLASH_FWD_WIDE_FROM) and the parent's
    does not run that body (its out and lse then differ by design)."""
    from ipdm_tpu_torch.ops.cuda import _build
    name = "flash_attn_f32" if dtype_name == "float32" else "flash_attn"
    return (_build.flash_counter(name, hd) == f"{name}_wide"
            and not lib.fwd_wide_from)


def wide_fwd_case(lib, hd, T, dtype_name, seed, reps):
    """The parent's forward and this tree's at head dim ``hd`` on seeded
    N(0, 1) q, k, v [4, T, hd]: each held to the plain forward (out at
    chip_smoke.py's rule of the dtype, the lse by lse_check), their
    distance, each timed A B B A (device ms, the f32 split pre-pass
    included), SDPA's time and the bound beside them."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed + hd + T)
    q, k, v = (torch.randn((4, T, hd), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    c2l = scale * scale * math.log2(math.e)
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    out_p, lse_p = parent_forward(lib, q, k, v, c2l)
    want = attention.attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    rtol, atol = cs.flash_tol(want, dtype_name)

    def over(o):
        return float(((o.float() - want.float()).abs()
                      / (atol + rtol * want.float().abs())).max())

    new_over, parent_over = over(out), over(out_p)
    del want
    lse_over = cs.lse_check(lse, q, k, scale, dtype_name)[0]
    parent_lse_over = cs.lse_check(lse_p, q, k, scale, dtype_name)[0]
    t = abba(lambda: parent_forward(lib, q, k, v, c2l),
             lambda: attention._forward(q, k, v, scale, with_lse=True), reps)
    sdpa = cs.sdpa_ms(q, k, v, scale, reps)
    bound = cs.flash_bound(4, T, hd, dtype_name, "fwd")
    res = dict(kernel="flash_wide_fwd", dtype=dtype_name, hd=hd, T=T,
               over=new_over, parent_over=parent_over, lse_over=lse_over,
               parent_lse_over=parent_lse_over,
               fwd_body_changed=wide_fwd_is_new(lib, hd, dtype_name),
               out_gap=float((out.float() - out_p.float()).abs().max()),
               lse_gap=float((lse - lse_p).abs().max()),
               parent_ms=t["parent"], new_ms=t["new"], sdpa_ms=sdpa,
               bound_ms=bound)
    cs.log(f"ab: flash_fwd {cs.SHORT[dtype_name]} [4,{T},{hd}] N(0, 1): out "
           f"at {new_over:.4f} of chip_smoke's rule (parent "
           f"{parent_over:.4f}), lse at {lse_over:.4f} of lse_check's bound "
           f"(parent {parent_lse_over:.4f}); parent − new max |diff| out "
           f"{res['out_gap']:.3e}, lse {res['lse_gap']:.3e}"
           + (" (the new wide body against the parent's)"
              if res["fwd_body_changed"] else "")
           + f"; device ms parent {t['parent'][0]:.4f}, new "
           f"{t['new'][0]:.4f}, new {t['new'][1]:.4f}, parent "
           f"{t['parent'][1]:.4f}; SDPA "
           + ("not run" if sdpa is None else f"{sdpa:.4f}")
           + f"; bound {bound:.4f}")
    if new_over > 1.0 or lse_over > 1.0:
        raise AssertionError(f"flash fwd hd {hd} T={T} {dtype_name}: over "
                             f"{new_over}, lse {lse_over}")
    return res


# the backward at the widths of its wide body: (head dim, T) in f32 and in
# bf16 (hd 128 in bf16 is its instance's: the parent's kernel both sides)
WIDE_BWD_SHAPES = {
    "float32": ((128, 7125), (160, 7125), (192, 7125), (256, 4096),
                (256, 7125), (320, 7125), (512, 7125)),
    "bfloat16": ((128, 7125), (256, 4097), (256, 7125), (512, 7125))}


def wide_bwd_case(lib, hd, T, dtype_name, seed, reps):
    """The parent's backward kernels and this tree's at head dim ``hd`` on
    seeded N(0, 1) q, k, v, dO [4, T, hd], with this tree's forward's out
    and lse: each held to the plain backward (:func:`bwd_rule_over`),
    their distance, dq and dkv each timed A B B A (device ms: D, the
    split pre-pass and the kernel), SDPA's backward alone at the same
    inputs and the bounds. Both sides pad a head dim between the kernels'
    widths (hd 160 runs at 192)."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed + hd + T + 1)
    q, k, v, do = (torch.randn((4, T, hd), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    args = (q, k, v, out, lse, do, scale)
    # as the autograd backward runs them: one split of q, k, v and dO,
    # the dq kernel's pre-pass, taken ready by dkv
    split = attention._bwd_split(q, attention.flash_instance(hd))
    ready = split is not None
    dq, D = attention.flash_bwd_dq(*args, split=split)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale,
                                     split=split, ready=ready)
    # the parent's kernels through stand-ins of the wrappers (the padding
    # of a head dim between widths on both sides)
    p_dq, p_dkv = parent_bwd_fns(lib)
    dq_p, D_p = p_dq(*args)
    dk_p, dv_p = p_dkv(q, k, v, lse, do, D_p, scale)

    def parent_dq():
        p_dq(*args)

    def parent_dkv():
        p_dkv(q, k, v, lse, do, D, scale)
    torch.cuda.synchronize()
    ref = cs._plain_long(q, k, v, do, scale) if dtype_name == "float32" \
        else None
    over = bwd_rule_over(dtype_name, (dq, dk, dv), args, ref)
    parent_over = bwd_rule_over(dtype_name, (dq_p, dk_p, dv_p), args, ref)
    del ref
    gaps = [float((a.float() - b.float()).abs().max())
            for a, b in ((dq, dq_p), (dk, dk_p), (dv, dv_p), (D, D_p))]
    del dq, dk, dv, dq_p, dk_p, dv_p
    def new_dq():
        attention.flash_bwd_dq(*args, split=split)

    def new_dkv():
        attention.flash_bwd_dkv(q, k, v, lse, do, D, scale, split=split,
                                ready=ready)
    t_dq = abba(parent_dq, new_dq, reps)
    t_dkv = abba(parent_dkv, new_dkv, reps)
    parts = {kind: {side: bwd_parts_ms(fn, reps) for side, fn in sides}
             for kind, sides in (("dq", (("parent", parent_dq),
                                         ("new", new_dq))),
                                 ("dkv", (("parent", parent_dkv),
                                          ("new", new_dkv))))}
    sdpa = cs.sdpa_bwd_ms(q, k, v, do, scale, reps)
    r = dict(kernel="flash_wide_bwd", dtype=dtype_name, hd=hd, T=T,
             over=over, parent_over=parent_over, parent_gaps=gaps,
             bwd_body_changed=wide_bwd_is_new(lib, hd, dtype_name),
             dq_parent_ms=t_dq["parent"], dq_new_ms=t_dq["new"],
             dkv_parent_ms=t_dkv["parent"], dkv_new_ms=t_dkv["new"],
             dq_device=parts["dq"], dkv_device=parts["dkv"],
             sdpa_bwd_ms=sdpa,
             dq_bound_ms=cs.flash_bound(4, T, hd, dtype_name, "dq"),
             dkv_bound_ms=cs.flash_bound(4, T, hd, dtype_name, "dkv"))
    cs.log(f"ab: flash_bwd {cs.SHORT[dtype_name]} [4,{T},{hd}] N(0, 1): "
           f"dq/dk/dv at " + " / ".join(f"{x:.4f}" for x in over)
           + " of the rule (parent " + " / ".join(f"{x:.4f}"
                                                  for x in parent_over)
           + "); parent − new max |diff| dq/dk/dv/D "
           + " / ".join(f"{g:.3e}" for g in gaps)
           + f"; event ms a call (D, split, kernel, padding) dq parent "
           f"{t_dq['parent'][0]:.4f}, new "
           f"{t_dq['new'][0]:.4f}, new {t_dq['new'][1]:.4f}, parent "
           f"{t_dq['parent'][1]:.4f} (bound {r['dq_bound_ms']:.4f}); dkv "
           f"parent {t_dkv['parent'][0]:.4f}, new {t_dkv['new'][0]:.4f}, "
           f"new {t_dkv['new'][1]:.4f}, parent {t_dkv['parent'][1]:.4f} "
           f"(bound {r['dkv_bound_ms']:.4f}); device ms a call under the "
           f"profiler, body + D + split: " + "; ".join(
               f"{kind} {side} " + " + ".join(
                   f"{parts[kind][side][x]:.4f}" for x in ("body", "D",
                                                          "split"))
               for kind in ("dq", "dkv") for side in ("parent", "new"))
           + "; SDPA backward alone (device ms under the profiler) "
           + ("not run" if sdpa is None else f"{sdpa:.4f}"))
    if max(over) > 1.0:
        raise AssertionError(f"wide bwd hd {hd} T={T} {dtype_name}: {over}")
    return r


def bwd_parts_ms(fn, calls) -> dict:
    """Device ms a call of fn() (a flash backward call) under
    torch.profiler, by part: ``body`` (the dq or dkv kernel), ``D``
    (flash_bwd_dot_kernel), ``split`` (the pre-pass) and ``other`` (the
    padding copies, the rest)."""
    parts = dict(body=0.0, D=0.0, split=0.0, other=0.0)
    for name, (ms, _) in cs.device_times(fn, calls).items():
        key = ("D" if "flash_bwd_dot_kernel" in name else
               "split" if "split_kernel" in name else
               "body" if "flash_bwd" in name else "other")
        parts[key] += ms / calls
    return parts


def parent_bwd_fns(lib):
    """Stand-ins for attention.flash_bwd_dq / flash_bwd_dkv (their
    signatures and results) that launch the parent's kernels on the
    tensors padded to the width that runs them (a given split is not
    used: the parent's kernels split for themselves)."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import _build, attention

    def dq_fn(q, k, v, out, lse, do, scale, split=None):
        hd = q.shape[2]
        inst = attention.flash_instance(hd)
        qp, kp, vp, op, dop = attention._pad(inst, q, k, v, out, do)
        BH, T, _ = qp.shape
        dq = torch.empty_like(qp)
        D = torch.empty((BH, T), dtype=torch.float32, device=q.device)
        _build.check(lib.flash_bwd_dq_launch(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(),
            dop.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            *split_args(lib, qp), BH, T, *hd_args(lib, qp),
            scale * scale * math.log2(math.e), scale * scale,
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q)),
            "parent flash_bwd_dq")
        return attention._cut(hd, dq)[0], D

    def dkv_fn(q, k, v, lse, do, D, scale, split=None, ready=False):
        hd = q.shape[2]
        inst = attention.flash_instance(hd)
        qp, kp, vp, dop = attention._pad(inst, q, k, v, do)
        BH, T, _ = qp.shape
        dk, dv = torch.empty_like(kp), torch.empty_like(vp)
        _build.check(lib.flash_bwd_dkv_launch(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *split_args(lib, qp), *((0,) if lib.bwd_wide_from else ()),
            BH, T, *hd_args(lib, qp), scale * scale * math.log2(math.e),
            scale * scale, int(q.dtype == torch.bfloat16),
            _build.stream_ptr(q)), "parent flash_bwd_dkv")
        return tuple(attention._cut(hd, dk, dv))

    return dq_fn, dkv_fn


WIDE_TRAIN_STEPS = 3   # timed train steps a turn, after 2 warm-up steps


def wide_train_case(lib, seed):
    """The train step of each UNet (examples/bench_train_torch.py's:
    make_train_step, remat, Adam) at the train presets with
    model_channels :data:`WIDE_SLICE_MC` (f32, head dim 256; img 512²,
    proj 2000×912, B = 1), seeded random weights and images, with the
    flash backward's kernels from the parent's library or this tree's, in
    the order parent, new, new, parent: per turn s/step (host clock of
    :data:`WIDE_TRAIN_STEPS` steps to a synchronize), the flash
    backward's event ms a step (chip_smoke.py BwdTimer: CUDA events
    around its 5 dq and 5 dkv wrapper calls: D, the split pre-pass, the
    kernels, the padding copies) and, from one more step under
    torch.profiler, the device ms of its dq and dkv kernels and D
    (``bwd_device_ms``) and of every split pre-pass of the step, the
    forward's and the backward's (``split_device_ms``)."""
    import time

    import numpy as np
    import torch
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import diffusion_for
    from ipdm_tpu_torch.engine.trainer import (make_optimizer,
                                               make_train_step)
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import attention

    new = {n: getattr(attention, n) for n in cs.BwdTimer.NAMES}
    parent = dict(zip(cs.BwdTimer.NAMES, parent_bwd_fns(lib)))
    res = []
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for domain, shape in (("img", (1, 512, 512, 1)),
                              ("proj", (1, 2000, 912, 1))):
            opt = IPDMConfig().merge(dict(
                cs._train_preset(domain),
                **{f"model_channels_{domain}": WIDE_SLICE_MC}))
            dev = torch.device("cuda")
            torch.manual_seed(seed)
            model = build_unet(opt, domain, device=dev, remat=True)
            step = make_train_step(
                model, diffusion_for(opt, domain, dev),
                make_optimizer(model.parameters(), opt.init_lr),
                opt[f"partial_timesteps_{domain}"],
                torch.Generator(device=dev).manual_seed(seed))
            images = torch.as_tensor(np.random.default_rng(seed).random(
                shape, np.float32), device=dev)
            got = {"parent": [], "new": []}
            for side in ("parent", "new", "new", "parent"):
                fns = parent if side == "parent" else new
                for n, fn in fns.items():
                    setattr(attention, n, fn)
                try:
                    for _ in range(2):
                        step(images)
                    torch.cuda.synchronize()
                    with cs.BwdTimer(attention) as timer:
                        t0 = time.perf_counter()
                        for _ in range(WIDE_TRAIN_STEPS):
                            step(images)
                        torch.cuda.synchronize()
                        s_step = (time.perf_counter() - t0) / WIDE_TRAIN_STEPS
                    bwd = sum(timer.ms()) / WIDE_TRAIN_STEPS
                    kern = cs.device_times(lambda: step(images), 1)
                finally:
                    for n, fn in new.items():
                        setattr(attention, n, fn)
                dev = sum(ms for name, (ms, _) in kern.items()
                          if "flash_bwd" in name)
                split_ms = sum(ms for name, (ms, _) in kern.items()
                               if "split_kernel" in name)
                got[side].append(dict(s=s_step, bwd_event_ms=bwd,
                                      bwd_device_ms=dev,
                                      split_device_ms=split_ms,
                                      calls=len(timer.ms())))
                cs.log(f"ab: wide train mc {WIDE_SLICE_MC} {domain} f32 "
                       f"({side}'s backward kernels): {s_step:.4f} s/step; "
                       f"the flash backward {bwd:.3f} event ms a step "
                       f"({len(timer.ms()) // WIDE_TRAIN_STEPS} wrapper "
                       f"calls a step); profiled step: its dq, dkv and D "
                       f"kernels {dev:.3f} device ms, every split pre-pass "
                       f"(forward and backward) {split_ms:.3f}")
            res.append(dict(kernel="wide_train", domain=domain,
                            mc=WIDE_SLICE_MC, parent=got["parent"],
                            new=got["new"]))
            del model, step, images
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return res


# the wide phase's slice: chip_smoke.py's shipped test preset (f32) with
# both UNets at this model_channels (head dim 256)
WIDE_SLICE_MC = 256


def _fwd_device_ms(prof) -> tuple:
    """(launches, device ms) of the flash forward's kernels (the wide
    body and its split pre-pass) in a finished torch.profiler run."""
    n, ms = 0, 0.0
    for name, (c, t) in cs.device_kernels(prof).items():
        if "flash_wide_kernel" in name or "split_kernel" in name:
            n, ms = n + c, ms + t
    return n, ms


def wide_slice_case(lib, seed):
    """chip_smoke.py's wide phase slice at mc :data:`WIDE_SLICE_MC` (f32,
    cuDNN in TF32 as main_torch.py runs it, seeded random weights and
    sinogram) with the f32 forward launched from the parent's library
    (attention._forward swapped for the parent's kernel) or this tree's,
    in the order parent, new, new, parent after a first slice of each:
    per turn a timed slice (s/slice, host clock to a synchronize) and a
    profiled one (the forward's launches and device ms: its kernels'
    durations summed)."""
    import math
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import attention

    mc = WIDE_SLICE_MC
    opt = dict(cs.shipped_preset(), compute_dtype="float32",
               model_channels_img=mc, model_channels_proj=mc)
    torch.manual_seed(seed)
    models = [build_unet(opt, d, device="cuda").eval()
              for d in ("proj", "img")]
    host = np.random.default_rng(seed)
    ld_proj = torch.as_tensor(host.random((1, 2000, 912, 1), np.float32)
                              * 4.0, device="cuda")
    new_forward = attention._forward

    def parent_forward_wrapped(q, k, v, scale, with_lse=False):
        if q.device.type == "cpu":
            return new_forward(q, k, v, scale, with_lse)
        hd = q.shape[2]
        inst = attention.flash_instance(hd)
        qp, kp, vp = attention._pad(inst, q, k, v)
        out, lse = parent_forward(lib, qp, kp, vp,
                                  scale * scale * math.log2(math.e))
        out, = attention._cut(hd, out)
        return (out, lse) if with_lse else out

    def run(side, s):
        attention._forward = (parent_forward_wrapped if side == "parent"
                              else new_forward)
        try:
            gen = torch.Generator(device="cuda").manual_seed(s)
            out = progressive_denoiser(opt, *models, ld_proj, gen)
            torch.cuda.synchronize()
            return out
        finally:
            attention._forward = new_forward

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {"parent": [], "new": []}
    try:
        with torch.no_grad():
            outs = {side: run(side, seed + 1) for side in ("parent", "new")}
            gap = float((outs["parent"] - outs["new"]).abs().max())
            size = float(outs["new"].abs().max())
            del outs
            for side in ("parent", "new", "new", "parent"):
                t0 = time.perf_counter()
                run(side, seed + 2)
                s_slice = time.perf_counter() - t0
                with torch.profiler.profile(
                        activities=[ProfilerActivity.CUDA]) as prof:
                    run(side, seed + 2)
                n, ms = _fwd_device_ms(prof)
                got[side].append(dict(s=s_slice, fwd_launches=n,
                                      fwd_device_ms=ms))
                cs.log(f"ab: wide slice mc {mc} f32 ({side}'s forward): "
                       f"{s_slice:.4f} s/slice; profiled slice: the "
                       f"forward's {n} launches (wide body and split "
                       f"pre-pass) {ms:.3f} device ms")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    cs.log(f"ab: wide slice mc {mc}: the parent's and the new forward's "
           f"first slices differ by max |diff| {gap:.3e} (max |out| "
           f"{size:.3e})")
    return dict(kernel="wide_slice", mc=mc, slice_gap=gap, slice_size=size,
                parent=got["parent"], new=got["new"])


def wide_inputs_case(lib, seed, mc):
    """The forward's inputs of chip_smoke.py's wide phase at ``mc`` (the
    first call of each shape in the f32 ART slice, as its Recorder takes
    them): the parent's forward and this tree's, each held to the plain
    forward at chip_smoke.py's f32 rule (the share of it each reads)."""
    import math

    import numpy as np
    import torch
    from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import attention

    opt = dict(cs.shipped_preset(), compute_dtype="float32",
               model_channels_img=mc, model_channels_proj=mc)
    torch.manual_seed(seed)
    models = [build_unet(opt, d, device="cuda").eval()
              for d in ("proj", "img")]
    host = np.random.default_rng(seed)
    ld_proj = torch.as_tensor(host.random((1, 2000, 912, 1), np.float32)
                              * 4.0, device="cuda")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = []
    try:
        with torch.no_grad():
            with cs.Recorder(unet, "flash_attention",
                             key=lambda a: tuple(a[0].shape)) as fa:
                progressive_denoiser(opt, *models, ld_proj, torch.Generator(
                    device="cuda").manual_seed(seed + 2))
            for args, _ in fa.calls:
                q, k, v, scale = args
                hd = q.shape[2]
                inst = attention.flash_instance(hd)
                out = attention.flash_attention(q, k, v, scale)
                out_p, _ = parent_forward(
                    lib, *attention._pad(inst, q, k, v),
                    scale * scale * math.log2(math.e))
                want = attention.attention_plain(q, k, v, scale)
                rtol, atol = cs.flash_tol(want, "float32")

                def over(o):
                    return float(((o[..., :hd] - want).abs()
                                  / (atol + rtol * want.abs())).max())
                r = dict(kernel="wide_inputs", mc=mc, T=q.shape[1], hd=hd,
                         over=over(out), parent_over=over(out_p))
                cs.log(f"ab: wide phase mc {mc}, its forward's first call "
                       f"at T = {r['T']}: out at {r['over']:.4f} of the f32 "
                       f"rule (parent {r['parent_over']:.4f})")
                res.append(r)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return res


# a stand-in for flash_narrow.cu's entry beside a variant build of
# flash_attn.cu (whose head-dim-8 f32 forward calls it; no variant case
# runs that head dim)
NARROW_STUB = """#include <cuda_runtime.h>
int flash_narrow_f32(const void*, const void*, const void*, void*, void*,
                     void*, int, int, float, cudaStream_t) {
  return (int)cudaErrorInvalidValue;
}
"""
# the wide forward's build constants, in --wide-variants' order
WIDE_CONSTANTS = cs.WIDE_CONSTANTS
# the variants' cases: (head dim, T), each in bf16 and f32
WIDE_VARIANT_SHAPES = ((128, 7125), (256, 4096), (256, 7125), (512, 7125))


def build_wide_variants(keys) -> dict:
    """csrc/flash_attn.cu built at each key (:data:`WIDE_CONSTANTS`) with
    a stand-in for the narrow entry (:func:`build_variants`, which logs
    each build's registers and spills), the two forward entries typed:
    {key: CDLL}."""
    from ipdm_tpu_torch.ops.cuda import _build

    libs = build_variants("flash_attn.cu", "flash_wide_kernel", {
        key: {f"IPDM_WIDE_{n}": x for n, x in zip(WIDE_CONSTANTS, key)}
        for key in keys}, NARROW_STUB)
    for lib in libs.values():
        for entry in ("flash_attn_launch", "flash_attn_f32_launch"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build.SIGNATURES[entry], ctypes.c_int
    return libs


# a stand-in for flash_narrow_bwd.cu's entry beside a variant build of
# flash_bwd.cu (no variant case runs head dim 8)
NARROW_BWD_STUB = """#include <cuda_runtime.h>
extern "C" int flash_narrow_bwd_launch(int, const void*, const void*,
                                       const void*, const void*,
                                       const void*, const void*, void*,
                                       void*, void*, int, int, float, float,
                                       int, void*) {
  return (int)cudaErrorInvalidValue;
}
"""
# the wide backward's build constants, in --wide-bwd-variants' order
WIDE_BWD_CONSTANTS = cs.WIDE_BWD_CONSTANTS
WIDE_BWD_VARIANT_SHAPES = ((128, 7125), (192, 7125), (256, 4096),
                           (256, 7125), (320, 7125), (512, 7125))


def build_wide_bwd_variants(keys) -> dict:
    """csrc/flash_bwd.cu built at each key (:data:`WIDE_BWD_CONSTANTS`)
    with a stand-in for the narrow entry, the two backward entries typed:
    {key: CDLL}."""
    from ipdm_tpu_torch.ops.cuda import _build

    libs = build_variants("flash_bwd.cu", "flash_bwd_wide_kernel", {
        key: {f"IPDM_WBWD_{n}": x for n, x in zip(WIDE_BWD_CONSTANTS, key)}
        for key in keys}, NARROW_BWD_STUB)
    for lib in libs.values():
        for entry in ("flash_bwd_dq_launch", "flash_bwd_dkv_launch"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build.SIGNATURES[entry], ctypes.c_int
    return libs


def wide_bwd_variant_case(libs, hd, T, dtype_name, seed, reps):
    """Each variant build of the wide backward on seeded N(0, 1) q, k, v,
    dO [4, T, hd] with this tree's forward's out and lse: its dq, dk and
    dv held to the plain backward (:func:`bwd_rule_over`), beside this
    tree's build's (the wrappers) and their distance from them, dq and
    dkv each timed against this tree's build A B B A (event ms a call:
    D, the split pre-pass and the kernel)."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import _build, attention

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed + hd + T + 1)
    q, k, v, do = (torch.randn((4, T, hd), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    args = (q, k, v, out, lse, do, scale)
    dq0, D0 = attention.flash_bwd_dq(*args)
    dk0, dv0 = attention.flash_bwd_dkv(q, k, v, lse, do, D0, scale)
    ref = cs._plain_long(q, k, v, do, scale) if dtype_name == "float32" \
        else None
    shipped_over = bwd_rule_over(dtype_name, (dq0, dk0, dv0), args, ref)
    c2, c2l = scale * scale, scale * scale * math.log2(math.e)
    bf16 = int(dtype_name == "bfloat16")
    split = attention._bwd_split(q, hd)
    sp = None if split is None else split.data_ptr()
    res = []
    for key, lib in libs.items():
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        D = torch.empty_like(lse)

        def var_dq(lib=lib, dq=dq, D=D):
            _build.check(lib.flash_bwd_dq_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
                sp, 4, T, hd, c2l, c2, bf16, _build.stream_ptr(q)),
                f"flash_bwd_dq {key}")

        def var_dkv(lib=lib, dk=dk, dv=dv, D=D):
            _build.check(lib.flash_bwd_dkv_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                sp, 0, 4, T, hd, c2l, c2, bf16, _build.stream_ptr(q)),
                f"flash_bwd_dkv {key}")

        var_dq()
        var_dkv()
        torch.cuda.synchronize()
        over = bwd_rule_over(dtype_name, (dq, dk, dv), args, ref)
        gaps = [float((a_.float() - b_.float()).abs().max())
                for a_, b_ in ((dq, dq0), (dk, dk0), (dv, dv0), (D, D0))]
        t_dq = abba(lambda: attention.flash_bwd_dq(*args), var_dq, reps)
        t_dkv = abba(lambda: attention.flash_bwd_dkv(
            q, k, v, lse, do, D0, scale), var_dkv, reps)
        r = dict(kernel="flash_wide_bwd_variant", dtype=dtype_name, hd=hd,
                 T=T, variant=list(key), over=over,
                 shipped_over=shipped_over, shipped_gaps=gaps,
                 dq_shipped_ms=t_dq["parent"], dq_variant_ms=t_dq["new"],
                 dkv_shipped_ms=t_dkv["parent"],
                 dkv_variant_ms=t_dkv["new"])
        cs.log(f"ab: flash_bwd_wide {cs.SHORT[dtype_name]} [4,{T},{hd}] "
               f"build {key}: dq/dk/dv at "
               + " / ".join(f"{x:.4f}" for x in over)
               + " of the rule (shipped " + " / ".join(
                   f"{x:.4f}" for x in shipped_over)
               + "); variant − shipped max |diff| dq/dk/dv/D "
               + " / ".join(f"{g:.3e}" for g in gaps)
               + f"; event ms a call dq shipped "
               f"{t_dq['parent'][0]:.4f}, variant {t_dq['new'][0]:.4f}, "
               f"variant {t_dq['new'][1]:.4f}, shipped "
               f"{t_dq['parent'][1]:.4f}; dkv shipped "
               f"{t_dkv['parent'][0]:.4f}, variant {t_dkv['new'][0]:.4f}, "
               f"variant {t_dkv['new'][1]:.4f}, shipped "
               f"{t_dkv['parent'][1]:.4f}")
        if max(over + shipped_over) > 1.0:
            raise AssertionError(f"wide bwd variant {key} hd {hd} T={T} "
                                 f"{dtype_name}: {over}, shipped "
                                 f"{shipped_over}")
        res.append(r)
    return res


def wide_variant_case(libs, hd, T, dtype_name, seed, reps):
    """Each variant build of the wide forward on seeded N(0, 1) q, k, v
    [4, T, hd]: held to the plain forward (out at chip_smoke.py's rule,
    the lse by its lse_check) and timed against this tree's build (the
    wrapper) A B B A."""
    import math

    import torch
    from ipdm_tpu_torch.ops.cuda import _build, attention

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed + hd + T)
    q, k, v = (torch.randn((4, T, hd), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    c2l = scale * scale * math.log2(math.e)
    want = attention.attention_plain(q, k, v, scale)
    rtol, atol = cs.flash_tol(want, dtype_name)
    f32 = dtype_name == "float32"
    split = (torch.empty(attention._fwd_split(4, T, hd), dtype=torch.bfloat16,
                         device="cuda") if f32 else None)

    def shipped():
        return attention._forward(q, k, v, scale, with_lse=True)

    res = []
    for key, lib in libs.items():
        out = torch.empty_like(q)
        lse = torch.empty((4, T), dtype=torch.float32, device="cuda")

        def variant(lib=lib, out=out, lse=lse):
            ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
            if f32:
                ptrs.append(split.data_ptr())
            entry = "flash_attn_f32_launch" if f32 else "flash_attn_launch"
            _build.check(getattr(lib, entry)(
                *ptrs, out.data_ptr(), lse.data_ptr(), 4, T, hd, c2l,
                _build.stream_ptr(q)), f"flash_wide {key}")

        variant()
        torch.cuda.synchronize()
        over = float(((out.float() - want.float()).abs()
                      / (atol + rtol * want.float().abs())).max())
        lse_over = cs.lse_check(lse, q, k, scale, dtype_name)[0]
        t = abba(shipped, variant, reps)
        r = dict(kernel="flash_wide_variant", dtype=dtype_name, hd=hd, T=T,
                 variant=dict(zip(WIDE_CONSTANTS, key)), over=over,
                 lse_over=lse_over, shipped_ms=t["parent"],
                 variant_ms=t["new"])
        cs.log(f"ab: flash_wide {cs.SHORT[dtype_name]} [4,{T},{hd}] build "
               + ", ".join(f"{n} {x}" for n, x in zip(WIDE_CONSTANTS, key))
               + f": out at {over:.4f} of the rule, lse at {lse_over:.4f}; "
               f"device ms shipped {t['parent'][0]:.4f}, variant "
               f"{t['new'][0]:.4f}, variant {t['new'][1]:.4f}, shipped "
               f"{t['parent'][1]:.4f}")
        if over > 1.0 or lse_over > 1.0:
            raise AssertionError(f"wide variant {key} hd {hd} T={T} "
                                 f"{dtype_name}: {over}, lse {lse_over}")
        res.append(r)
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
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    groups = ("deposit", "anterp", "flash_fwd", "flash_bwd", "wide_bwd",
              "wide_train", "wide_slice")
    ap.add_argument("--kernels", nargs="+", choices=groups, default=groups)
    ap.add_argument("--same-bits", action="store_true",
                    help="exit 1 unless every output of every kernel is "
                         "bit-equal to the parent's")
    ap.add_argument("--narrow-variants", nargs="+", metavar="NWG,KT",
                    help="time csrc/flash_narrow.cu built at these "
                         "(warpgroups, sub-tiles) against this tree's "
                         "build instead of a parent")
    ap.add_argument("--narrow-bwd-variants", nargs="+",
                    metavar="NWG,KT",
                    help="time csrc/flash_narrow_bwd.cu built at these "
                         "build constants against this tree's build "
                         "instead of a parent")
    ap.add_argument("--wide-variants", nargs="+",
                    metavar=",".join(WIDE_CONSTANTS),
                    help="time csrc/flash_attn.cu's wide forward built at "
                         "these build constants against this tree's build "
                         "instead of a parent")
    ap.add_argument("--wide-bwd-variants", nargs="+",
                    metavar=",".join(WIDE_BWD_CONSTANTS),
                    help="time csrc/flash_bwd.cu's wide backward built at "
                         "these build constants against this tree's build "
                         "instead of a parent")
    a = ap.parse_args()
    if sum(x is not None for x in (a.parent, a.narrow_variants,
                                   a.narrow_bwd_variants, a.wide_variants,
                                   a.wide_bwd_variants)) != 1:
        ap.error("give one of --parent DIR, --narrow-variants, "
                 "--narrow-bwd-variants, --wide-variants, "
                 "--wide-bwd-variants")
    import torch
    if not torch.cuda.is_available():
        print("torch_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    from ipdm_tpu_torch.ops.cuda import _build

    smi = cs.nvidia_smi_line()
    cs.log(f"ab: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.library()
    if a.wide_bwd_variants:
        cs.log("ab: the shipped wide backward's build: " + ", ".join(
            f"{n} {x}" for n, x in cs.wide_bwd_build().items()))
        libs = build_wide_bwd_variants([tuple(int(x) for x in pv.split(
            ",")) for pv in a.wide_bwd_variants])
        res = []
        with torch.no_grad():
            for hd, T in WIDE_BWD_VARIANT_SHAPES:
                for dtype_name in ("bfloat16", "float32"):
                    res += wide_bwd_variant_case(libs, hd, T, dtype_name,
                                                 a.seed, max(2, a.reps // 4))
                    torch.cuda.empty_cache()
        line = json.dumps({"device": smi, "ab": res})
        if a.out:
            os.makedirs(a.out.parent, exist_ok=True)
            a.out.write_text(line + "\n")
        print(line)
        return 0
    if a.wide_variants:
        cs.log("ab: the shipped wide forward's build: " + ", ".join(
            f"{n} {x}" for n, x in cs.wide_build().items()))
        libs = build_wide_variants([tuple(int(x) for x in pv.split(","))
                                    for pv in a.wide_variants])
        res = []
        with torch.no_grad():
            for hd, T in WIDE_VARIANT_SHAPES:
                for dtype_name in ("bfloat16", "float32"):
                    res += wide_variant_case(libs, hd, T, dtype_name, a.seed,
                                             max(2, a.reps // 4))
        line = json.dumps({"device": smi, "ab": res})
        if a.out:
            os.makedirs(a.out.parent, exist_ok=True)
            a.out.write_text(line + "\n")
        print(line)
        return 0
    if a.narrow_variants or a.narrow_bwd_variants:
        if a.narrow_variants:
            libs = build_narrow_variants([tuple(int(x) for x in pv.split(
                ",")) for pv in a.narrow_variants])
            case = narrow_variant_case
        else:
            names = ("NWG", "KT")
            keys = [tuple(int(x) for x in pv.split(","))
                    for pv in a.narrow_bwd_variants]
            libs = build_variants("flash_narrow_bwd.cu",
                                  "flash_narrow_bwd_kernel", {
                                      key: {f"IPDM_NARROW_BWD_{n}": x
                                            for n, x in zip(names, key)}
                                      for key in keys})
            case = narrow_bwd_variant_case
        res = []
        with torch.no_grad():
            for T in NARROW_T:
                res += case(libs, T, a.seed, max(2, a.reps // 4))
        line = json.dumps({"device": smi, "ab": res})
        if a.out:
            os.makedirs(a.out.parent, exist_ok=True)
            a.out.write_text(line + "\n")
        print(line)
        return 0
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
            dims = AB_HEAD_DIMS + (AB_WIDE_HEAD_DIMS if lib.wide else ())
            with torch.no_grad():
                for hd in dims:
                    for dtype_name in ("bfloat16", "float32"):
                        res.append(flash_head_dim_case(
                            lib, hd, dtype_name, a.seed, max(2, a.reps // 4)))
                if "flash_fwd" in a.kernels and lib.wide:
                    for hd, T in WIDE_FWD_SHAPES:
                        for dtype_name in ("bfloat16", "float32"):
                            res.append(wide_fwd_case(
                                lib, hd, T, dtype_name, a.seed,
                                max(2, a.reps // 4)))
                            torch.cuda.empty_cache()
                for T in NARROW_T:
                    if "flash_fwd" in a.kernels:
                        res.append(narrow_case(lib, T, a.seed,
                                               max(2, a.reps // 4)))
                    if "flash_bwd" in a.kernels:
                        res.append(narrow_bwd_case(lib, T, a.seed,
                                                   max(2, a.reps // 4)))
    if "wide_bwd" in a.kernels and lib.takes_hd and lib.wide:
        with torch.no_grad():
            for dtype_name, shapes in WIDE_BWD_SHAPES.items():
                for hd, T in shapes:
                    res.append(wide_bwd_case(lib, hd, T, dtype_name,
                                             a.seed, max(2, a.reps // 4)))
                    torch.cuda.empty_cache()
    if "wide_train" in a.kernels and lib.takes_hd and lib.wide:
        res += wide_train_case(lib, a.seed)
    if "wide_slice" in a.kernels and lib.takes_hd and lib.wide:
        res.append(wide_slice_case(lib, a.seed))
        with torch.no_grad():
            for mc in cs.WIDE_WIDTHS:
                res += wide_inputs_case(lib, a.seed, mc)
    line = json.dumps({"device": smi, "ab": res})
    if a.out:
        os.makedirs(a.out.parent, exist_ok=True)
        a.out.write_text(line + "\n")
    gap_keys = ("parent_gap", "out_gap", "lse_gap")
    differ = [(r["kernel"], r.get("dtype"), r.get("T"), r.get("hd"))
              for r in res
              if any(r.get(k) for k in gap_keys[
                  :1 if r.get("fwd_body_changed") else 3])
              or any(r.get("parent_gaps", ())[
                  3 if r.get("bwd_body_changed") else 0:])]
    if a.same_bits:
        cs.log(f"ab: outputs bit-equal to the parent's: "
               + ("all" if not differ else f"not {differ}"))
    print(line)
    return 1 if a.same_bits and differ else 0


if __name__ == "__main__":
    sys.exit(main())

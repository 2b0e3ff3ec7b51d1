#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``ipdm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without a result line:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds ``ipdm_tpu_torch/csrc/*.cu`` for sm_90a;
3. record  — one proj UNet eval, one img UNet eval and one batched FBP at
   full width, with each kernel wrapper's inputs recorded: these are the
   tensors the main path hands the kernels; then the device time of each
   of the three;
4. kernels — each kernel against its plain PyTorch version on those
   inputs (max |diff| within the stated tolerance), with CUDA-event times
   of the kernel, the plain version and, where one PyTorch call computes
   the same function, that call; and the least time the card could take
   (bytes over 3.35 TB/s or operations over the peak rate of their type);
5. reference — the whole FBP-mode pipeline at a small size, f32, zero
   noise, on the card (kernels) against the CPU (plain versions);
6. slice   — the FBP-mode progressive denoise of one slice with bench.py's
   FBP settings (proj UNet 2000×912 and img UNet 512², bf16 activations,
   seeded random weights; 3×15 proj steps at λ=0.5, η=0.4; batched FBP of
   the four kept iterations; sharpen 70; 3×15 img steps at λ=0.45, η=0.7):
   the main-path run with the launch counts of its kernels (each > 0),
   output shape and finiteness, peak memory; more timed slices; one slice
   under torch.profiler: device time by kernel and the idle share;
7. record-ART — one OS-SART convert of four full-width sinograms (B=4,
   nstart=10, 40 subsets) with a plan built anew, recording the inputs of
   os_sart_sweep, anterp_taps, fp_plane_deposit and bp_shift; the
   once-per-plan launches; the convert's device time with the plan built;
8. kernels-ART — each new kernel against its plain version on those
   inputs (the sweep on the last sweep of each drive, where x ≠ 0);
9. reference-ART — the ART-mode pipeline at a small size (per-pixel proj
   λ, OS-SART, ultra pass), f32, card against CPU: with the same noise on
   both; with zero noise, where the convert's output is held to 1e-3 of
   its range and the final image to the CPU's own spread under a one-ulp
   change of the input (the image stage is ill-conditioned at zero
   noise); the TV convert and the adaptive proj mode (t_start=None, its
   noise class);
10. slice-ART — the ART-mode slice with bench.py's ART settings (proj
   per-pixel λ after a cosine-λ probe, 3×15 steps, η=0.5; OS-SART of the
   four kept iterations, nstart=10, 40 subsets; 3×15 img steps at λ=0.45,
   η=0.7; the ultra pass, 3×5 steps at λ=0.6, η=0.6; 105 UNet evals): the
   main-path run on a plan built anew (every kernel > 0), then warm
   slices split into proj stage / convert / img stage, launches per warm
   slice, peak memory, one profiled slice;
11. the ``kernels`` JSON line, the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero when no CUDA device is present. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (dense): device memory, bf16 tensor cores, f32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SLICE_OPT = dict(
    convertor="FBP", fbp_sharpen=True, normal=False, ultra_img_denoise=False,
    compute_dtype="bfloat16",
    in_channels_img=1, out_channels_img=1, model_channels_img=64,
    attention_resolutions_img=[8, 16], channel_mult_img=[1, 1, 2, 2, 4, 4],
    timesteps_img=1000, schedule_power_img=1, t_start_img=[15, 15, 15],
    clip_img=True, eta_img=0.7, constant_guidance_img=0.45,
    sample_method_img="dense",
    in_channels_proj=1, out_channels_proj=1, model_channels_proj=64,
    attention_resolutions_proj=[16, 32],
    channel_mult_proj=[0.0625, 0.125, 0.25, 2, 2, 4, 4],
    timesteps_proj=1000, schedule_power_proj=1, t_start_proj=[15, 15, 15],
    clip_proj=False, eta_proj=0.4, constant_guidance_proj=0.5,
    sample_method_proj="dense")
# bench.py:186-240's ART mode (the Mayo preset's: per-pixel proj λ after a
# cosine-λ probe, OS-SART convert, no sharpen, the ultra pass)
ART_SLICE_OPT = dict(
    SLICE_OPT, convertor="ART", ultra_img_denoise=True,
    constant_guidance_proj=None, eta_proj=0.5, lambda_ratio_proj=1,
    kernel_size_proj=4, amplitude_proj=7, sart_nstart=10, sart_subsets=40,
    ntv=0, sart_sample_rate=1)
SHARPEN = 70  # bench.py's FBP-mode sharpen strength
SEED = 0      # weights, inputs and noise
REPS = 20     # timed launches per kernel measurement
# kernels each path's main-path run must launch
FBP_KERNELS = ("planar_unit", "flash_attn", "bp_shift")
ART_KERNELS = FBP_KERNELS + ("fp_plane_deposit", "os_sart_sweep",
                             "anterp_taps")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


class Recorder:
    """Replaces ``module.name`` by a wrapper that records each call's
    arguments, for as long as the ``with`` block runs."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        setattr(self.module, self.name, self._record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def _record(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def phase_record(models, ld_proj):
    """One eval of each UNet and one batched convert at full width, with
    the kernel wrappers' inputs recorded."""
    import torch
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.recon import fbp_fast
    from ipdm_tpu_torch.recon.convertor import Convertor

    proj_model, img_model = models
    dev = torch.device("cuda")
    x_proj = ld_proj.permute(0, 3, 1, 2).contiguous()
    x_img = torch.rand((1, 1, 512, 512), device=dev)
    t = torch.full((1,), 7, dtype=torch.long, device=dev)
    with torch.inference_mode(), \
            Recorder(unet, "planar_unit") as pu, \
            Recorder(unet, "flash_attention") as fa, \
            Recorder(fbp_fast, "bp_shift_accumulate_batched") as bp:
        proj_model(x_proj, t)
        n_proj_attn = len(fa.calls)
        img_model(x_img, t)
        sino = ld_proj[..., 0].expand(4, -1, -1).contiguous()
        Convertor("FBP")(sino)
    torch.cuda.synchronize()
    log(f"record: proj eval {len(pu.calls)} planar units, {n_proj_attn} "
        f"flash attentions; img eval {len(fa.calls) - n_proj_attn} flash "
        f"attentions; convert {len(bp.calls)} BP groups")
    with torch.inference_mode():
        proj_ms = cuda_ms(lambda: proj_model(x_proj, t), 5)
        img_ms = cuda_ms(lambda: img_model(x_img, t), 5)
        fbp_ms = cuda_ms(lambda: Convertor("FBP")(sino), 5)
    log(f"record: proj UNet eval {proj_ms:.3f} ms, img UNet eval "
        f"{img_ms:.3f} ms, FBP of 4 sinograms {fbp_ms:.3f} ms")
    return pu.calls, fa.calls, bp.calls


def bound_ms(nbytes: float, flops: float, flops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate and
    operations over the peak rate of their type, in ms."""
    return dict(bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=flops / flops_per_s * 1e3)


def _within(got, want, rtol, atol):
    d = (got.float() - want.float()).abs()
    ok = bool((d <= atol + rtol * want.float().abs()).all())
    return ok, float(d.max())


def summarise(rows, tag, name, source, replaces, stats, library):
    """Append a kernel's row of the kernels JSON line: the means over its
    checked calls; bound_by is the larger of the summed byte and operation
    bounds."""
    n = len(stats)
    by_bytes = sum(s["bytes_ms"] for s in stats)
    by_ops = sum(s["ops_ms"] for s in stats)
    bound_by = "bytes" if by_bytes >= by_ops else "operations"
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=0,
               max_abs_err=max(s["err"] for s in stats),
               ms=sum(s["ms"] for s in stats) / n,
               plain_ms=sum(s["plain_ms"] for s in stats) / n,
               bound_ms=sum(max(s["bytes_ms"], s["ops_ms"])
                            for s in stats) / n,
               bound_by=bound_by,
               library_ms=(None if not library else
                           sum(s["library_ms"] for s in stats) / n))
    rows.append(row)
    log(f"{tag}: {name}: {n} main-path calls, mean per launch "
        f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {bound_by}"
        + (f", library {row['library_ms']:.4f} ms" if library else "")
        + f"), max |diff| {row['max_abs_err']:.3e}")


def phase_kernels(calls, reps):
    """Each kernel against its plain version on the recorded inputs, with
    its times and bound. Returns the rows of the kernels JSON line."""
    import torch
    import torch.nn.functional as F
    from ipdm_tpu_torch.ops.cuda import attention, planar, shift

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pu_calls, fa_calls, bp_calls = calls
    rows = []

    with torch.inference_mode():
        # planar_unit: bf16 within one bf16 rounding of the plain version
        # (both sum in f32, in another order), f32 to 1e-4 (f32 units run
        # in the reference phase)
        stats = []
        for args, kw in pu_calls:
            x, a, bb, w, bias, skip = args
            act = kw.get("act", True)
            bf16 = x.dtype == torch.bfloat16
            rtol, atol = (2.0 ** -7, 1e-2) if bf16 else (1e-4, 1e-4)
            got = planar.planar_unit(x, a, bb, w, bias, skip, act=act)
            want = planar.planar_unit_plain(x, a, bb, w, bias, skip, act=act)
            torch.cuda.synchronize()
            ok, err = _within(got, want, rtol, atol)
            B, C, H, W = x.shape
            O = w.shape[3]
            es = x.element_size()
            nbytes = es * B * H * W * (C + O * (2 if skip is not None else 1))
            flops = 2 * 9 * C * O * B * H * W
            s = dict(err=err, **bound_ms(nbytes, flops,
                                         BF16_FLOPS if bf16 else F32_FLOPS),
                     ms=cuda_ms(lambda: planar.planar_unit(
                         x, a, bb, w, bias, skip, act=act), reps),
                     plain_ms=cuda_ms(lambda: planar.planar_unit_plain(
                         x, a, bb, w, bias, skip, act=act), reps))
            log(f"kernels: planar_unit {str(x.dtype)[6:]} C={C} O={O} "
                f"{H}x{W} act={int(act)} skip={int(skip is not None)}: "
                f"max |diff| {err:.3e} (tol {atol:g} + {rtol:g}·|plain|) "
                f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            if not ok:
                raise AssertionError(f"planar_unit disagrees at C={C} O={O} "
                                     f"{H}x{W}: max |diff| {err}")
            stats.append(s)
        summarise(rows, "kernels", "planar_unit",
                  "ipdm_tpu_torch/csrc/planar_unit.cu",
                  "ipdm_tpu/ops/pallas/planar.py:190", stats, False)

        # flash attention: bf16 outputs of an f32 softmax; the two round
        # the weights at different points (normalised vs not)
        stats = []
        seen = {}
        for args, kw in fa_calls:
            q, k, v, scale = args
            key = tuple(q.shape)
            if key in seen:   # same shape as a timed call: count it again
                stats.append(seen[key])
                continue
            got = attention.flash_attention(q, k, v, scale)
            want = attention.attention_plain(q, k, v, scale)
            torch.cuda.synchronize()
            ok, err = _within(got, want, 2e-2, 2e-2)
            BH, T, hd = q.shape
            nbytes = 4 * BH * T * hd * q.element_size()
            flops = 4 * BH * T * T * hd
            q4, k4, v4 = (t_.view(1, BH, T, hd) for t_ in (q, k, v))
            s = dict(err=err, **bound_ms(nbytes, flops, BF16_FLOPS),
                     ms=cuda_ms(lambda: attention.flash_attention(
                         q, k, v, scale), reps),
                     plain_ms=cuda_ms(lambda: attention.attention_plain(
                         q, k, v, scale), max(2, reps // 4)),
                     library_ms=cuda_ms(
                         lambda: F.scaled_dot_product_attention(
                             q4, k4, v4, scale=scale * scale), reps))
            log(f"kernels: flash_attn [{BH},{T},{hd}] bf16: max |diff| "
                f"{err:.3e} (tol 2e-2 + 2e-2·|plain|) {s['ms']:.4f} ms, "
                f"plain {s['plain_ms']:.4f} ms, SDPA "
                f"{s['library_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            if not ok:
                raise AssertionError(f"flash attention disagrees at T={T}: "
                                     f"max |diff| {err}")
            seen[key] = s
            stats.append(s)
        summarise(rows, "kernels", "flash_attn",
                  "ipdm_tpu_torch/csrc/flash_attn.cu",
                  "ipdm_tpu/models/unet.py:601", stats, True)

        # BP: f32 sums over ~500 views in another order
        stats = []
        for args, kw in bp_calls:
            Q, s0, s1, fr, n = args
            got = shift.bp_shift_accumulate_batched(Q, s0, s1, fr, n)
            want = shift.bp_shift_accumulate_plain(Q, s0, s1, fr, n)
            torch.cuda.synchronize()
            atol = 1e-5 * float(want.abs().max())
            ok, err = _within(got, want, 1e-4, atol)
            V, B, L = Q.shape
            nbytes = 4 * (V * B * L + 3 * V * n + B * n * n)
            flops = 4 * V * B * n * n
            s = dict(err=err, **bound_ms(nbytes, flops, F32_FLOPS),
                     ms=cuda_ms(lambda: shift.bp_shift_accumulate_batched(
                         Q, s0, s1, fr, n), reps),
                     plain_ms=cuda_ms(lambda: shift.bp_shift_accumulate_plain(
                         Q, s0, s1, fr, n), max(2, reps // 4)))
            log(f"kernels: bp_shift V={V} B={B} L={L} n={n}: max |diff| "
                f"{err:.3e} (tol {atol:.2e} + 1e-4·|plain|) {s['ms']:.4f} "
                f"ms, plain {s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            if not ok:
                raise AssertionError(f"bp_shift disagrees at V={V}: "
                                     f"max |diff| {err}")
            stats.append(s)
        summarise(rows, "kernels", "bp_shift", "ipdm_tpu_torch/csrc/bp_shift.cu",
                  "ipdm_tpu/ops/pallas/shift.py:119", stats, False)
    return rows


def phase_reference(seed: int) -> None:
    """The FBP-mode pipeline at a small size in f32 with zero noise: the
    card (kernels) against the CPU (plain versions)."""
    import torch
    from ipdm_tpu_torch.diffusion import diffusion
    from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
    from ipdm_tpu_torch.models.unet import UNetModel
    from ipdm_tpu_torch.recon.convertor import Convertor
    from ipdm_tpu_torch.recon.fbp import FBPGeometry
    from ipdm_tpu_torch.ops.cuda import _build

    torch.manual_seed(seed)
    proj = UNetModel(in_channels=1, model_channels=16, out_channels=1,
                     num_res_blocks=1, attention_resolutions=(4,),
                     channel_mult=(0.25, 0.5, 1, 2), num_heads=2,
                     device="cpu")
    img = UNetModel(in_channels=1, model_channels=8, out_channels=1,
                    num_res_blocks=1, attention_resolutions=(2,),
                    channel_mult=(1, 1, 2), num_heads=2, device="cpu")
    geom = FBPGeometry(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
                       da=0.0010125 * 912 / 128, det_offset=3.75,
                       view_step_deg=1.0)
    opt = dict(SLICE_OPT, t_start_proj=[3, 3], t_start_img=[3, 3],
               compute_dtype="float32")
    x = np.random.default_rng(seed).random((1, 360, 128, 1), np.float32)
    noise_like = diffusion.noise_like
    diffusion.noise_like = lambda t, g: torch.zeros_like(t)
    try:
        outs = []
        for dev in ("cpu", "cuda"):
            pm, im = copy.deepcopy(proj).to(dev), copy.deepcopy(img).to(dev)
            before = dict(_build.LAUNCHES)
            outs.append(progressive_denoiser(
                opt, pm, im, x, None, convertor=Convertor("FBP", geom),
                sharpen_num=SHARPEN, device=dev).cpu())
            used = {k: _build.LAUNCHES[k] - before[k] for k in before}
    finally:
        diffusion.noise_like = noise_like
    cpu, gpu = outs
    err = float((cpu - gpu).abs().max())
    scale = float(cpu.abs().max())
    log(f"reference: 64x64 FBP-mode pipeline, f32, zero noise: card vs CPU "
        f"max |diff| {err:.3e} (tol 1e-3·max|cpu| = {1e-3 * scale:.3e}); "
        f"card launches {used}")
    if not (torch.isfinite(gpu).all() and err <= 1e-3 * scale):
        raise AssertionError(f"small-input pipeline: card and CPU differ by "
                             f"{err} (max |cpu| {scale})")
    if not (used["planar_unit"] > 0 and used["bp_shift"] > 0):
        raise AssertionError(f"small-input pipeline skipped a kernel: {used}")


class StageTimer:
    """A convertor wrapper that splits a slice into proj stage, convert and
    img stage on the host clock, with torch.cuda.synchronize() at the
    convert's two ends."""

    def __init__(self, convertor):
        self.convertor = convertor
        self.marks = []

    def __call__(self, pj):
        import torch
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        out = self.convertor(pj)
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        return out


def phase_slice(label: str, opt: dict, models, ld_proj, seed: int,
                path_kernels, n_evals: int, n_timed: int,
                fresh_plan: bool = False):
    """One mode's full-width slice: the main-path run with the launch
    counters reset just before it and read just after (with a plan built
    anew when ``fresh_plan``, as a user's first ART slice builds it), then
    ``n_timed`` timed slices split into proj stage / convert / img stage,
    the launches of one warm slice, and one slice under torch.profiler
    (device time by kernel, and the device's idle share). Returns the
    main-path run's and the warm slice's launch counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ipdm_tpu_torch.engine.denoiser import (make_convertor,
                                                progressive_denoiser)
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import sart_fast

    proj_model, img_model = models
    tag = "slice" if label == "FBP" else "slice-ART"

    n = make_convertor(opt).fbp_geom.grid_n

    def run(s, timer=None):
        gen = torch.Generator(device=ld_proj.device).manual_seed(s)
        return progressive_denoiser(opt, proj_model, img_model, ld_proj,
                                    gen, convertor=timer,
                                    sharpen_num=SHARPEN)

    if not fresh_plan:   # the FBP plan has no once-per-plan kernels
        t0 = time.perf_counter()
        run(seed + 1)
        torch.cuda.synchronize()
        log(f"{tag}: warm-up slice {time.perf_counter() - t0:.3f} s")
    else:
        sart_fast._SPLANS.clear()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = run(seed + 2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(out).all())
    log(f"{tag}: the main-path run{' (plan built in it)' if fresh_plan else ''}"
        f" {dt:.4f} s, {n_evals} UNet evals, launches {launches}, output "
        f"{tuple(out.shape)} {out.dtype} finite={finite} mean "
        f"{float(out.mean()):.5f}, peak memory {peak:.2f} GiB")
    if tuple(out.shape) != (1, n, n, 1) or not finite:
        raise AssertionError(f"{label} slice output {tuple(out.shape)} "
                             f"finite={finite}")
    missing = [k for k in path_kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} main "
                             f"path: {missing}")
    times, splits = [], []
    for i in range(n_timed):
        timer = StageTimer(make_convertor(opt))
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        run(seed + 3 + i, timer)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            warm = dict(_build.LAUNCHES)
        times.append(t1 - t0)
        c0, c1 = timer.marks
        splits.append((c0 - t0, c1 - c0, t1 - c1))
    mean = sum(times) / n_timed
    log(f"{tag}: s/slice over {n_timed} warm slices "
        f"{[round(t, 4) for t in times]}, mean {mean:.4f}; launches per "
        f"warm slice {warm}")
    for name, k in (("proj stage", 0), ("convert", 1), ("img stage", 2)):
        vals = [sp[k] for sp in splits]
        log(f"{tag}: {name} {[round(v, 4) for v in vals]} s, mean "
            f"{sum(vals) / n_timed:.4f} s")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(seed + 9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    log(f"{tag} profile: one slice, {wall:.4f} s wall under the profiler; "
        f"device kernel time {busy:.4f} s = {100 * busy / mean:.1f}% "
        f"of the unprofiled {mean:.4f} s/slice (idle "
        f"{100 * (1 - busy / mean):.1f}%)")
    for e in kernels[:25]:
        log(f"{tag} profile: {dev_us(e) / 1e3:10.3f} ms {e.count:7d}x  "
            f"{e.key[:100]}")
    return launches, warm


def phase_record_art(ld_proj):
    """One ART convert of four full-width sinograms with its plan built
    anew, recording the inputs of the four kernel wrappers as
    recon/sart_fast.py calls them. Returns the calls and the launches of
    that first convert (the once-per-plan kernels launch only there)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import sart_fast
    from ipdm_tpu_torch.recon.convertor import Convertor

    conv = Convertor("ART", nstart=ART_SLICE_OPT["sart_nstart"],
                     nsubsets=ART_SLICE_OPT["sart_subsets"], ntv=0)
    # four distinct sinograms, as the four kept proj iterations are
    scale = torch.tensor([1.0, 0.9, 1.1, 0.95], device=ld_proj.device)
    sino = (ld_proj[..., 0] * scale[:, None, None]).contiguous()
    sart_fast._SPLANS.clear()
    _build.reset_launches()
    names = ("os_sart_sweep", "anterp_taps", "fp_plane_deposit",
             "bp_shift_accumulate_batched")
    recs = [Recorder(sart_fast, nm) for nm in names]
    t0 = time.perf_counter()
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        for r in recs:
            stack.enter_context(r)
        img = conv(sino)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    first = dict(_build.LAUNCHES)
    log(f"record-ART: first convert of 4 sinograms (plan and norms built): "
        f"{cold:.3f} s, launches {first}; output {tuple(img.shape)} "
        f"finite={bool(torch.isfinite(img).all())} max "
        f"{float(img.abs().max()):.4f}")
    n = conv.fbp_geom.grid_n
    if tuple(img.shape) != (4, n, n) or not torch.isfinite(img).all():
        raise AssertionError(f"ART convert output {tuple(img.shape)}")
    with torch.inference_mode():
        ms = cuda_ms(lambda: conv(sino), 3, warmup=1)
    log(f"record-ART: OS-SART convert of 4 sinograms, plan built: "
        f"{ms:.3f} ms")
    return {nm: r.calls for nm, r in zip(names, recs)}, first


def phase_kernels_art(calls, reps):
    """The three SART kernels against their plain versions on the
    recorded inputs, with their times and bounds; bp_shift on a few of
    the norms' calls. Returns the rows of the kernels JSON line."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    rows = []

    def row(name, source, replaces, stats):
        summarise(rows, "kernels-ART", name, source, replaces, stats, False)

    def check(label, got, want, rtol, atol_rel):
        torch.cuda.synchronize()
        atol = atol_rel * float(want.abs().max())
        ok, err = _within(got, want, rtol, atol)
        if not ok:
            raise AssertionError(f"{label} disagrees: max |diff| {err} "
                                 f"(tol {atol:.3e} + {rtol:g}·|plain|)")
        return err, f"max |diff| {err:.3e} (tol {atol:.2e} + {rtol:g}·|plain|)"

    def check_sum(label, got, want, absum, nterms):
        """Within the f32 error bound of two summation orders of nterms
        terms: 2·nterms·2⁻²⁴·Σ|terms| per output (absum = the plain
        version on absolute values)."""
        torch.cuda.synchronize()
        d = (got - want).abs()
        tol = 2 * nterms * 2.0 ** -24 * absum
        err = float(d.max())
        if not bool((d <= tol).all()):
            raise AssertionError(f"{label} disagrees: max |diff| {err}, "
                                 f"max |diff|/bound "
                                 f"{float((d / tol.clamp_min(1e-30)).max())}")
        return err, (f"max |diff| {err:.3e}, max |diff|/bound "
                     f"{float((d / tol.clamp_min(1e-30)).max()):.2e} (bound "
                     f"2·{nterms}·2^-24·Σ|terms|)")

    with torch.inference_mode():
        # f32 sums over rows (deposit, 2n terms per bin) or taps (anterp,
        # Wt terms), in another order: the summation error bound
        stats = []
        for args, kw in calls["fp_plane_deposit"]:
            rows_, s0, s1, w0, w1, L = args
            err, msg = check_sum(
                "fp_plane_deposit", shift.fp_plane_deposit(*args),
                shift.fp_plane_deposit_plain(*args),
                shift.fp_plane_deposit_plain(rows_.abs(), s0, s1, w0.abs(),
                                             w1.abs(), L),
                2 * rows_.shape[0])
            n, B, W = rows_.shape
            V = s0.shape[0]
            live = int((w0 != 0).any(dim=1).sum())
            nbytes = 4 * (n * B * W + 4 * V * n + V * B * L)
            flops = 4 * live * n * B * W
            s = dict(err=err, **bound_ms(nbytes, flops, F32_FLOPS),
                     ms=cuda_ms(lambda: shift.fp_plane_deposit(*args), reps),
                     plain_ms=cuda_ms(
                         lambda: shift.fp_plane_deposit_plain(*args), 3))
            log(f"kernels-ART: fp_plane_deposit V={V} ({live} live) B={B} "
                f"n={n} W={W} L={L}: {msg} {s['ms']:.4f} ms, plain "
                f"{s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            stats.append(s)
        row("fp_plane_deposit", "ipdm_tpu_torch/csrc/fp_deposit.cu",
            "ipdm_tpu/ops/pallas/shift.py:279", stats)

        stats = []
        for args, kw in calls["anterp_taps"]:
            P, qi0, W = args
            err, msg = check_sum(
                "anterp_taps", shift.anterp_taps(*args, **kw),
                shift.anterp_taps_plain(*args),
                shift.anterp_taps_plain(P.abs(), qi0, W.abs()), W.shape[1])
            V, B, Ntp = P.shape
            Wt, Lp = W.shape[1], W.shape[2]
            nbytes = 4 * (V * B * Ntp + V * Lp + V * Wt * Lp + V * B * Lp)
            flops = 2 * Wt * V * B * Lp
            s = dict(err=err, **bound_ms(nbytes, flops, F32_FLOPS),
                     ms=cuda_ms(lambda: shift.anterp_taps(*args, **kw),
                                reps),
                     plain_ms=cuda_ms(lambda: shift.anterp_taps_plain(*args),
                                      5))
            log(f"kernels-ART: anterp_taps V={V} B={B} Wt={Wt} Lp={Lp} "
                f"Ntp={Ntp}: {msg} {s['ms']:.4f} ms, plain "
                f"{s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            stats.append(s)
        row("anterp_taps", "ipdm_tpu_torch/csrc/anterp_taps.cu",
            "ipdm_tpu/ops/pallas/shift.py:702", stats)

        # the sweep on the last sweep of each drive (x != 0; the first
        # sweep starts from x = 0 and its FP is all zeros). 2·32 dependent
        # subset updates of f32 sums in another order: 1e-5 of the largest
        # pixel plus 1e-4 of each. Beside it, how far a sweep that drops
        # its last subset lands from the plain one (a fault the tolerance
        # has to see)
        stats = []
        sweeps = calls["os_sart_sweep"]
        for args, kw in sweeps[-2:]:
            x, rf, inv2, frac, s0, nrmi, lam = args
            if not float(x.abs().max()) > 0:
                raise AssertionError("os_sart_sweep held on x = 0")
            want = shift.os_sart_sweep_plain(*args)
            err, msg = check("os_sart_sweep",
                             shift.os_sart_sweep(*args, **kw), want, 1e-4,
                             1e-5)
            short = shift.os_sart_sweep_plain(
                x, *(a[:-1] for a in (rf, inv2, frac, s0, nrmi)), lam)
            over = float(((short - want).abs()
                          / (1e-5 * float(want.abs().max())
                             + 1e-4 * want.abs())).max())
            log(f"kernels-ART: os_sart_sweep with its last subset dropped: "
                f"max |diff| {float((short - want).abs().max()):.3e}, "
                f"{over:.1f}× the tolerance at its worst pixel")
            S, Vp, B, L = rf.shape
            n = x.shape[-1]
            live = int((inv2 != 0).any(dim=2).sum())
            nbytes = 4 * (2 * B * n * n + S * Vp * B * L + S * Vp * L
                          + 2 * S * Vp * n + S * n * n)
            flops = 8 * live * B * n * n + 2 * S * Vp * B * L + 4 * S * B * n * n
            s = dict(err=err, **bound_ms(nbytes, flops, F32_FLOPS),
                     ms=cuda_ms(lambda: shift.os_sart_sweep(*args, **kw),
                                reps),
                     plain_ms=cuda_ms(
                         lambda: shift.os_sart_sweep_plain(*args), 2, 1))
            log(f"kernels-ART: os_sart_sweep S={S} Vp={Vp} ({live} live "
                f"views) B={B} n={n} L={L} lam={lam:.4f} max|x|="
                f"{float(x.abs().max()):.4f}: {msg} {s['ms']:.4f} ms, plain "
                f"{s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms "
                f"(bytes {s['bytes_ms']:.4f}, operations {s['ops_ms']:.4f})")
            stats.append(s)
        row("os_sart_sweep", "ipdm_tpu_torch/csrc/os_sart_sweep.cu",
            "ipdm_tpu/ops/pallas/shift.py:544", stats)

        # bp_shift on the norms' calls (V=16, B=1): the first and the last
        # of each drive
        bp = calls["bp_shift_accumulate_batched"]
        half = len(bp) // 2
        for args, kw in (bp[0], bp[half - 1], bp[half], bp[-1]):
            Q, s0, s1, fr, n = args
            err, msg = check("bp_shift (norms)",
                             shift.bp_shift_accumulate_batched(*args),
                             shift.bp_shift_accumulate_plain(*args), 1e-4,
                             1e-5)
            ms = cuda_ms(lambda: shift.bp_shift_accumulate_batched(*args),
                         reps)
            log(f"kernels-ART: bp_shift (norms) V={Q.shape[0]} "
                f"B={Q.shape[1]} L={Q.shape[2]} n={n}: {msg} {ms:.4f} ms")
    return rows


def phase_reference_art(seed: int) -> None:
    """The ART-mode pipeline at a small size in f32: the card (kernels)
    against the CPU (plain versions), the whole pipeline with the same
    noise on both devices (drawn from one CPU generator seeded alike) and
    with zero noise. At zero noise the image stage is ill-conditioned: the
    guidance term (x_t − √ᾱ·g)/√(1−ᾱ) of an iteration that barely moves
    the image is a tiny difference that std_normalize scales to unit
    variance, so a rounding difference grows through the iterations. So
    at zero noise the convert's output (proj stage and OS-SART) is held to
    1e-3 of its range, and the final image to 1e-3 of its range or twice
    the CPU's own spread, the larger: the CPU run again on the input moved
    up by one ulp."""
    import torch
    from ipdm_tpu_torch.diffusion import diffusion
    from ipdm_tpu_torch.diffusion.guided import guided_reverse_process
    from ipdm_tpu_torch.engine.denoiser import (diffusion_for,
                                                progressive_denoiser)
    from ipdm_tpu_torch.models.unet import UNetModel
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.ops.lambda_curve import proj_curve_init
    from ipdm_tpu_torch.recon.convertor import Convertor
    from ipdm_tpu_torch.recon.fbp import FBPGeometry

    torch.manual_seed(seed)
    proj = UNetModel(in_channels=1, model_channels=16, out_channels=1,
                     num_res_blocks=1, attention_resolutions=(4,),
                     channel_mult=(0.25, 0.5, 1, 2), num_heads=2,
                     device="cpu")
    img = UNetModel(in_channels=1, model_channels=8, out_channels=1,
                    num_res_blocks=1, attention_resolutions=(2,),
                    channel_mult=(1, 1, 2), num_heads=2, device="cpu")
    geom = FBPGeometry(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
                       da=0.0010125 * 912 / 128, det_offset=3.75,
                       view_step_deg=1.0)
    opt = dict(ART_SLICE_OPT, t_start_proj=[3, 3, 3], t_start_img=[3, 3],
               compute_dtype="float32")
    x = np.random.default_rng(seed).random((1, 360, 128, 1), np.float32)

    def set_noise(noise):
        gen = torch.Generator().manual_seed(seed)
        if noise == "shared":
            diffusion.noise_like = lambda t, g: torch.randn(
                t.shape, generator=gen, dtype=t.dtype).to(t.device)
        else:
            diffusion.noise_like = lambda t, g: torch.zeros_like(t)

    def run(noise, dev, xin):
        """The pipeline on ``dev``: (final image, the convert's output,
        the launches of the run)."""
        set_noise(noise)
        conv = Convertor("ART", geom, nstart=2, nsubsets=6)
        seen = []
        pm, im = copy.deepcopy(proj).to(dev), copy.deepcopy(img).to(dev)
        before = dict(_build.LAUNCHES)
        out = progressive_denoiser(
            opt, pm, im, xin, None,
            convertor=lambda pj: seen.append(conv(pj)) or seen[-1],
            device=dev)
        used = {k: _build.LAUNCHES[k] - before[k] for k in before}
        return out.cpu(), seen[0].cpu(), used

    def diff(a, b):
        return float((a - b).abs().max())

    def adaptive():
        """The adaptive proj mode (t_start=None: the probe, the one host
        read of the residual max, the noise class's schedule), shared
        noise; returns card vs CPU max |diff|, max|cpu| and the classes."""
        outs = []
        for dev in ("cpu", "cuda"):
            set_noise("shared")
            xd = torch.from_numpy(x).permute(0, 3, 1, 2).to(dev)
            its, ns = guided_reverse_process(
                copy.deepcopy(proj).to(dev), diffusion_for(opt, "proj", dev),
                xd, None, t_start=None, clip=False, eta=0.5, mode="proj",
                constant_guidance=None, lambda_ratio=1, kernel_size=4,
                amplitude=7, lambda_curve=proj_curve_init())
            outs.append((its[-1].cpu(), ns))
        (cpu, ns_cpu), (gpu, ns_gpu) = outs
        return diff(cpu, gpu), float(cpu.abs().max()), ns_cpu, ns_gpu

    x_ulp = np.nextafter(x, np.float32(np.inf)).astype(np.float32)
    noise_like = diffusion.noise_like
    try:
        cpu, _, _ = run("shared", "cpu", x)
        gpu, _, used = run("shared", "cuda", x)
        z_cpu, zc_cpu, _ = run("zero", "cpu", x)
        z_gpu, zc_gpu, z_used = run("zero", "cuda", x)
        z_ulp, zc_ulp, _ = run("zero", "cpu", x_ulp)
        ad_err, ad_scale, ns_cpu, ns_gpu = adaptive()
    finally:
        diffusion.noise_like = noise_like
    err, scale = diff(cpu, gpu), float(cpu.abs().max())
    zc_err, zc_scale = diff(zc_cpu, zc_gpu), float(zc_cpu.abs().max())
    z_err, z_scale = diff(z_cpu, z_gpu), float(z_cpu.abs().max())
    spread, c_spread = diff(z_cpu, z_ulp), diff(zc_cpu, zc_ulp)
    # the TV convert (OS-SART with a TV step per sweep), card vs CPU
    tv = Convertor("TV", geom, nstart=2, nsubsets=6)
    sino = torch.from_numpy(x[..., 0])
    tv_cpu, tv_gpu = tv(sino), tv(sino.cuda()).cpu()
    tv_err = diff(tv_cpu, tv_gpu)
    tv_scale = float(tv_cpu.abs().max())
    log(f"reference-ART: 64x64 ART-mode pipeline (per-pixel proj λ, "
        f"OS-SART nstart=2 over 6 subsets, ultra pass), f32, shared noise: "
        f"card vs CPU max |diff| {err:.3e} (tol 1e-3·max|cpu| = "
        f"{1e-3 * scale:.3e}); card launches {used}")
    log(f"reference-ART: zero noise, the convert's output (proj stage and "
        f"OS-SART): card vs CPU max |diff| {zc_err:.3e} (tol 1e-3·max|cpu| "
        f"= {1e-3 * zc_scale:.3e}); the CPU on the input + 1 ulp "
        f"{c_spread:.3e}")
    log(f"reference-ART: zero noise, the final image: card vs CPU max "
        f"|diff| {z_err:.3e} (max|cpu| {z_scale:.3e}); the CPU against "
        f"itself on the input + 1 ulp {spread:.3e} (tol the larger of "
        f"1e-3·max|cpu| and 2× that = "
        f"{max(1e-3 * z_scale, 2 * spread):.3e}); card launches {z_used}")
    log(f"reference-ART: Convertor('TV') (ntv=1), card vs CPU max |diff| "
        f"{tv_err:.3e} (tol 1e-3·max|cpu| = {1e-3 * tv_scale:.3e})")
    log(f"reference-ART: adaptive proj mode (t_start=None), shared noise: "
        f"noise class {ns_gpu} (CPU {ns_cpu}); card vs CPU max |diff| "
        f"{ad_err:.3e} (tol 1e-3·max|cpu| = {1e-3 * ad_scale:.3e})")
    if not (torch.isfinite(gpu).all() and err <= 1e-3 * scale):
        raise AssertionError(f"small-input ART pipeline: card and CPU "
                             f"differ by {err} (max |cpu| {scale})")
    if not (torch.isfinite(z_gpu).all() and zc_err <= 1e-3 * zc_scale
            and z_err <= max(1e-3 * z_scale, 2 * spread)):
        raise AssertionError(f"small-input ART pipeline, zero noise: card "
                             f"and CPU differ by {zc_err} after the convert"
                             f" and {z_err} at the end (CPU spread "
                             f"{spread})")
    if not (torch.isfinite(tv_gpu).all() and tv_err <= 1e-3 * tv_scale):
        raise AssertionError(f"TV convert: card and CPU differ by {tv_err}")
    if not (ns_gpu == ns_cpu and ad_err <= 1e-3 * ad_scale):
        raise AssertionError(f"adaptive proj mode: card and CPU differ "
                             f"({ns_gpu} / {ns_cpu}, {ad_err})")
    # no UNet this small reaches flash attention's 4096 tokens
    missing = [k for k in ART_KERNELS if k != "flash_attn" and used[k] <= 0]
    if missing:
        raise AssertionError(f"small-input ART pipeline skipped kernels: "
                             f"{missing}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import _build

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: nvcc sm_90a, {time.perf_counter() - t0:.1f} s")

    torch.manual_seed(SEED)
    models = (build_unet(SLICE_OPT, "proj", device="cuda").eval(),
              build_unet(SLICE_OPT, "img", device="cuda").eval())
    host = np.random.default_rng(SEED)
    ld_proj = torch.as_tensor(host.random((1, 2000, 912, 1), np.float32)
                              * 4.0, device="cuda")

    rows = phase_kernels(phase_record(models, ld_proj), REPS)
    phase_reference(SEED)
    fbp, _ = phase_slice("FBP", SLICE_OPT, models, ld_proj, SEED,
                         FBP_KERNELS, 90, n_timed=2)
    art_calls, per_plan = phase_record_art(ld_proj)
    rows += phase_kernels_art(art_calls, REPS)
    phase_reference_art(SEED)
    art, warm = phase_slice("ART", ART_SLICE_OPT, models, ld_proj, SEED,
                            ART_KERNELS, 105, n_timed=3, fresh_plan=True)
    for row in rows:
        name = row["name"]
        row["launches"] = art[name]          # the ART main-path run
        row["launches_per_warm_slice"] = warm[name]
        row["launches_fbp"] = fbp[name]      # the FBP main-path run
        if name in ("fp_plane_deposit", "anterp_taps", "bp_shift"):
            # the first convert's launches less those of a warm one
            row["launches_per_plan"] = per_plan[name] - warm[name]
        log(f"kernels: {name}: {row['launches']} launches in the ART "
            f"main-path run (plan built in it), {warm[name]} per warm ART "
            f"slice, {fbp[name]} per FBP slice; ~{warm[name] * row['ms']:.2f}"
            f" ms of kernel time per warm ART slice")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
11. record-FP — one ``project_fast`` of two 512² phantoms at the SIEMENS
   scanner (natural Kf = 2, 500 views per drive) with the kernel wrappers'
   inputs recorded, its launches, its device time; then one
   ``sart_fast_convert(..., mm_bf16=True)`` of four full-width sinograms
   (those two and their low-dose versions; nstart=10, 40 subsets) with
   its launches, beside the f32 convert of the same four;
12. kernels-FP — on those inputs fp_shift_deposit_batched, fp_shift_deposit
   (one item) and fp_plane_deposit against the plain deposit and against
   each other, and anterp_taps at Wt = 6; the bf16 mode of os_sart_sweep
   on the last sweep of each drive against its plain version, with its
   distance from the f32 sweep;
13. reference-FP — at 64², ``project_fast`` on the card against the CPU,
   both anterpolation forms, then ``sart_fast_convert`` of that sinogram
   back to an image, f32 and bf16 sweeps, with its PSNR against the
   phantom (a physics check);
14. engine — the steps of examples/synthetic_e2e_torch.py at full width
   in a temporary directory: a corpus of two slices (phantom →
   project_fast → add_noise at dose 0.25 → OS-SART), two checkpoints
   written from seeded weights, then
   ``ProgressiveDomainDenoiser(IPDMConfig(mode="test_prog", ...)).fit()``
   with the ART settings and all five metrics: checkpoints loaded, every
   kernel of the path launched, metric.json per slice and in aggregate,
   the engine's phase times; then one more slice through ``update_opt``:
   FBP with one converted iteration, which backprojects a single sinogram
   through bp_shift_accumulate, with that wrapper's inputs recorded;
15. kernels-BP1 — bp_shift_accumulate on those inputs (V=500, n=512)
   against its plain version and the batched kernel at B=1, and beside
   the row on two of the OS-SART norms' calls (V=16);
16. the ``kernels`` JSON line, the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero when no CUDA device is present. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import math
import os.path as osp
import subprocess
import sys
import tempfile
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
# the engine phase's run also builds its corpus: one project_fast per slice
ENGINE_KERNELS = ART_KERNELS + ("fp_shift_deposit",)
DOSE = 0.25   # the synthetic corpus's low dose


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

    with torch.inference_mode():
        # f32 sums over rows (deposit, 2n terms per bin) or taps (anterp,
        # Wt terms), in another order: the summation error bound
        stats = []
        for args, kw in calls["fp_plane_deposit"]:
            rows_, s0, s1, w0, w1, L = args
            err, msg = _sum_bound_check(
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
            err, msg = _sum_bound_check(
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


def _sum_bound_check(label, got, want, absum, nterms):
    """got within the f32 error bound of two summation orders of nterms
    terms, 2·nterms·2⁻²⁴·Σ|terms| per output (absum = the plain version on
    absolute values). Returns (max |diff|, message)."""
    import torch
    torch.cuda.synchronize()
    d = (got - want).abs()
    tol = 2 * nterms * 2.0 ** -24 * absum
    err = float(d.max())
    worst = float((d / tol.clamp_min(1e-30)).max())
    if not bool((d <= tol).all()):
        raise AssertionError(f"{label} disagrees: max |diff| {err}, max "
                             f"|diff|/bound {worst}")
    return err, (f"max |diff| {err:.3e}, max |diff|/bound {worst:.2e} "
                 f"(bound 2·{nterms}·2^-24·Σ|terms|)")


def phase_record_fp(seed: int):
    """One project_fast of two full-width phantoms, driven as a user
    building a corpus in batches drives it, with the launch counters reset
    just before and read just after, and the kernel wrappers' inputs
    recorded; then the bf16 convert of four sinograms made from them.
    Returns (calls, project_fast's launches, the bf16 convert's)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import sart_fast
    from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP as g
    from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom

    rng = np.random.default_rng(seed)
    vol = torch.as_tensor(np.stack([random_ellipse_phantom(512, rng)
                                    for _ in range(2)]).astype(np.float32),
                          device="cuda")
    project = lambda: sart_fast.project_fast(vol, g, g.N, float(g.nda[0]),
                                             float(g.da))
    names = ("fp_shift_deposit_batched", "anterp_taps")
    recs = [Recorder(sart_fast, nm) for nm in names]
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        for r in recs:
            stack.enter_context(r)
        fan = project()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    sp = sart_fast._splan_for(g, 1, fold=True)
    log(f"record-FP: project_fast of 2 phantoms 512² → {tuple(fan.shape)} "
        f"(plan built in it: Kf={sp.Kf}, Nt={sp.p.Nt}, per drive V="
        f"{sp.gx_all.V}/{sp.gy_all.V}, L={sp.gx_all.L}, Lq={sp.gx_all.Lq}): "
        f"{cold:.3f} s, finite={bool(torch.isfinite(fan).all())}, max "
        f"{float(fan.max()):.4f}; launches {launches}")
    if tuple(fan.shape) != (2, g.M, g.N) or not torch.isfinite(fan).all():
        raise AssertionError(f"project_fast output {tuple(fan.shape)}")
    missing = [k for k in names if launches[k] <= 0]
    if missing:
        raise AssertionError(f"project_fast skipped kernels: {missing}")
    with torch.inference_mode():
        ms = cuda_ms(project, 5, warmup=1)
        one = cuda_ms(lambda: sart_fast.project_fast(
            vol[:1], g, g.N, float(g.nda[0]), float(g.da)), 5, warmup=1)
    log(f"record-FP: project_fast, plan built: {ms:.3f} ms for 2 phantoms, "
        f"{one:.3f} ms for 1")
    return ({nm: r.calls for nm, r in zip(names, recs)}, launches,
            _convert_bf16(vol, fan, seed))


def _convert_bf16(vol, fan, seed: int):
    """``sart_fast_convert(..., mm_bf16=True)`` of four full-width
    sinograms (``fan`` and its low-dose version), as a user who asks for
    the bf16 sweeps calls it, with the launch counters reset just before
    and read just after; beside it the f32 convert of the same four.
    Returns the bf16 convert's launches."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import sart_fast
    from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP as g
    from ipdm_tpu_torch.recon.simulate import add_noise

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(nstart=10, nsubsets=40)
    with torch.inference_mode():
        pj = torch.cat([fan, add_noise(fan, gen, DOSE)])
        f32 = sart_fast.sart_fast_convert(pj, g, **kw)
        torch.cuda.synchronize()
        _build.reset_launches()
        bf16 = sart_fast.sart_fast_convert(pj, g, mm_bf16=True, **kw)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        ms = {m: cuda_ms(lambda: sart_fast.sart_fast_convert(
            pj, g, mm_bf16=m, **kw), 3, warmup=1) for m in (False, True)}
    ref = torch.cat([vol, vol]).transpose(1, 2)      # recon orientation
    psnr = lambda x: [round(10 * math.log10(
        float(r.max()) ** 2 / float(((a - r) ** 2).mean())), 2)
        for a, r in zip(x, ref)]
    gap, top = float((bf16 - f32).abs().max()), float(f32.abs().max())
    log(f"record-FP: sart_fast_convert(mm_bf16=True) of 4 sinograms (2 "
        f"full dose, 2 at dose {DOSE}; 10 sweeps of 40 subsets) → "
        f"{tuple(bf16.shape)}: launches {launches}; {ms[True]:.3f} ms (f32 "
        f"sweeps {ms[False]:.3f} ms); PSNR against the phantoms "
        f"{psnr(bf16)} dB (f32 sweeps {psnr(f32)} dB); bf16 − f32 max "
        f"|diff| {gap:.3e} at max|f32| {top:.4f} (tol 1e-2·max)")
    if (tuple(bf16.shape) != (4, g.grid_n, g.grid_n)
            or not torch.isfinite(bf16).all() or gap > 1e-2 * top
            or gap == 0.0 or min(psnr(bf16)) < 15.0):
        raise AssertionError(f"the bf16 convert: shape {tuple(bf16.shape)}, "
                             f"bf16 − f32 {gap}, PSNR {psnr(bf16)}")
    if launches["os_sart_sweep_bf16"] <= 0 or launches["os_sart_sweep"]:
        raise AssertionError(f"the bf16 convert's sweeps: {launches}")
    return launches


def phase_kernels_fp(fp_calls, art_calls, reps):
    """The deposits and the anterpolation on project_fast's inputs, the
    bf16 sweep on the recorded last sweep of each drive. Returns the rows
    of the kernels JSON line."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    rows = []
    tag = "kernels-FP"

    def row(name, source, replaces, stats):
        summarise(rows, tag, name, source, replaces, stats, False)

    with torch.inference_mode():
        st8, st9 = [], []
        for args, kw in fp_calls["fp_shift_deposit_batched"]:
            rows_, s0, s1, w0, w1, L = args
            n, B, W = rows_.shape
            V = s0.shape[0]
            want = shift.fp_plane_deposit_plain(*args)
            absum = shift.fp_plane_deposit_plain(rows_.abs(), s0, s1,
                                                 w0.abs(), w1.abs(), L)
            plane = shift.fp_plane_deposit(*args)
            batched = shift.fp_shift_deposit_batched(*args)
            one_rows = rows_[:, B - 1].contiguous()
            one_args = (one_rows, s0, s1, w0, w1, L)
            single = shift.fp_shift_deposit(*one_args)
            single_want = shift.fp_shift_deposit_plain(*one_args)
            e6, m6 = _sum_bound_check("fp_plane_deposit (project_fast)",
                                      plane, want, absum, 2 * n)
            e8, m8 = _sum_bound_check("fp_shift_deposit_batched", batched,
                                      want, absum, 2 * n)
            e9, m9 = _sum_bound_check("fp_shift_deposit", single,
                                      single_want, absum[:, B - 1], 2 * n)
            d86 = float((batched - plane).abs().max())
            d96 = float((single - plane[:, B - 1]).abs().max())
            if d86 != 0.0 or d96 != 0.0:   # same row order, same sums
                raise AssertionError(f"the shift deposits differ from "
                                     f"fp_plane_deposit: {d86}, {d96}")
            live = int((w0 != 0).any(dim=1).sum())
            t6 = cuda_ms(lambda: shift.fp_plane_deposit(*args), reps)
            s8 = dict(err=e8, **bound_ms(
                4 * (n * B * W + 4 * V * n + V * B * L),
                4 * live * n * B * W, F32_FLOPS),
                ms=cuda_ms(lambda: shift.fp_shift_deposit_batched(*args),
                           reps),
                plain_ms=cuda_ms(
                    lambda: shift.fp_plane_deposit_plain(*args), 3))
            s9 = dict(err=e9, **bound_ms(
                4 * (n * W + 4 * V * n + V * L), 4 * live * n * W,
                F32_FLOPS),
                ms=cuda_ms(lambda: shift.fp_shift_deposit(*one_args), reps),
                plain_ms=cuda_ms(
                    lambda: shift.fp_shift_deposit_plain(*one_args), 3))
            log(f"{tag}: deposits V={V} ({live} live) B={B} n={n} W={W} "
                f"L={L}: fp_shift_deposit_batched {m8} {s8['ms']:.4f} ms, "
                f"plain {s8['plain_ms']:.4f} ms, bound "
                f"{max(s8['bytes_ms'], s8['ops_ms']):.4f} ms; "
                f"fp_shift_deposit (item {B - 1}) {m9} {s9['ms']:.4f} ms, "
                f"plain {s9['plain_ms']:.4f} ms, bound "
                f"{max(s9['bytes_ms'], s9['ops_ms']):.4f} ms; "
                f"fp_plane_deposit {m6} {t6:.4f} ms; batched − plane "
                f"{d86:.1e}, single − plane {d96:.1e}")
            st8.append(s8)
            st9.append(s9)
        row("fp_shift_deposit_batched",
            "ipdm_tpu_torch/csrc/fp_shift_deposit.cu",
            "ipdm_tpu/ops/pallas/shift.py:354", st8)
        row("fp_shift_deposit", "ipdm_tpu_torch/csrc/fp_shift_deposit.cu",
            "ipdm_tpu/ops/pallas/shift.py:625", st9)

        for args, kw in fp_calls["anterp_taps"]:
            P, qi0, W = args
            err, msg = _sum_bound_check(
                "anterp_taps (project_fast)", shift.anterp_taps(*args, **kw),
                shift.anterp_taps_plain(*args),
                shift.anterp_taps_plain(P.abs(), qi0, W.abs()), W.shape[1])
            ms = cuda_ms(lambda: shift.anterp_taps(*args, **kw), reps)
            log(f"{tag}: anterp_taps (project_fast) V={P.shape[0]} "
                f"B={P.shape[1]} Wt={W.shape[1]} Lp={W.shape[2]} "
                f"Ntp={P.shape[2]}: {msg} {ms:.4f} ms")

        # the bf16 sweep on the last sweep of each drive, against the
        # plain version with the same bf16-rounded operands: the two sum
        # the same exact products in another order, and a last-bit
        # difference of a correction can move its bf16 rounding by one
        # step (2^-8 relative) in a few of the 2·16 products of a pixel:
        # 2e-6 of the largest pixel plus 2e-5 of each. Beside it the
        # distance from the f32 sweep, which has to lie well outside that
        # tolerance (the f32 sweep's own, 1e-5 + 1e-4, would not tell the
        # two modes apart on a late sweep)
        stats = []
        for args, kw in art_calls["os_sart_sweep"][-2:]:
            x, rf, inv2, frac, s0, nrmi, lam = args
            kw = dict(kw, bf16=True)
            want = shift.os_sart_sweep_plain(*args, bf16=True)
            got = shift.os_sart_sweep(*args, **kw)
            torch.cuda.synchronize()
            top = float(want.abs().max())
            ok, err = _within(got, want, 2e-5, 2e-6 * top)
            f32 = shift.os_sart_sweep_plain(*args)
            gap = float((f32 - want).abs().max())
            over = float(((f32 - want).abs()
                          / (2e-6 * top + 2e-5 * want.abs())).max())
            S, Vp, B, L = rf.shape
            n = x.shape[-1]
            live = int((inv2 != 0).any(dim=2).sum())
            nbytes = 4 * (2 * B * n * n + S * Vp * B * L + S * Vp * L
                          + 2 * S * Vp * n + S * n * n)
            b = bound_ms(nbytes, 0, F32_FLOPS)
            # the taps are bf16 products (tensor-core rate), the
            # correction and the update f32
            b["ops_ms"] = (8 * live * B * n * n / BF16_FLOPS
                           + (2 * S * Vp * B * L + 4 * S * B * n * n)
                           / F32_FLOPS) * 1e3
            s = dict(err=err, **b,
                     ms=cuda_ms(lambda: shift.os_sart_sweep(*args, **kw),
                                reps),
                     plain_ms=cuda_ms(lambda: shift.os_sart_sweep_plain(
                         *args, bf16=True), 2, 1))
            f32_ms = cuda_ms(lambda: shift.os_sart_sweep(
                *args, **dict(kw, bf16=False)), reps)
            log(f"{tag}: os_sart_sweep bf16 S={S} Vp={Vp} ({live} live "
                f"views) B={B} n={n} L={L} max|x|={float(x.abs().max()):.4f}"
                f": max |diff| {err:.3e} (tol {2e-6 * top:.2e} + "
                f"2e-5·|plain|); the f32 sweep lies {gap:.3e} away, "
                f"{over:.1f}× the tolerance at its worst pixel; "
                f"{s['ms']:.4f} ms (the f32 sweep {f32_ms:.4f} ms), plain "
                f"{s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms (bytes "
                f"{s['bytes_ms']:.4f}, operations {s['ops_ms']:.4f})")
            if not ok:
                raise AssertionError(f"os_sart_sweep bf16 disagrees: max "
                                     f"|diff| {err} (max|plain| {top})")
            if not over > 5.0:
                raise AssertionError(f"the bf16 tolerance does not tell the "
                                     f"bf16 sweep from the f32 one ({over})")
            stats.append(s)
        row("os_sart_sweep_bf16", "ipdm_tpu_torch/csrc/os_sart_sweep.cu",
            "ipdm_tpu/ops/pallas/shift.py:441", stats)
    return rows


def phase_reference_fp(seed: int) -> None:
    """At 64² (180 views of 128 detectors): project_fast on the card
    against the CPU plain path in both anterpolation forms, then the
    OS-SART convert of that sinogram back to an image, with f32 and with
    bf16 sweeps, card against CPU, and its PSNR against the phantom."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import sart_fast
    from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
    from ipdm_tpu_torch.recon.geometry import FanBeamGeometry
    from ipdm_tpu_torch.recon.phantom import shepp_logan

    geom = FanBeamGeometry(nx=64, ny=64, dx=42 / 64, dy=42 / 64, nr=128,
                           dr=0.0010125 * 912 / 128, na=180)
    g = fbp_geom_from_fan(geom)
    ph = shepp_logan(64).astype(np.float32)
    vol = torch.from_numpy(ph[None])
    args = (g, geom.nr, float(g.nda[0]), float(g.da))
    before = dict(_build.LAUNCHES)
    with torch.inference_mode():
        fan = {}
        for anterp in (True, False):
            cpu = sart_fast.project_fast(vol, *args, anterp=anterp)
            gpu = sart_fast.project_fast(vol.cuda(), *args,
                                         anterp=anterp).cpu()
            err, scale = float((cpu - gpu).abs().max()), float(cpu.max())
            log(f"reference-FP: 64² project_fast, "
                f"{'anterp_taps' if anterp else 'windowed-gather'} form: "
                f"card vs CPU max |diff| {err:.3e} (tol 1e-5·max|cpu| = "
                f"{1e-5 * scale:.3e})")
            if not (torch.isfinite(gpu).all() and err <= 1e-5 * scale):
                raise AssertionError(f"project_fast: card and CPU differ by "
                                     f"{err}")
            fan[anterp] = gpu
        forms = float((fan[True] - fan[False]).abs().max())
        log(f"reference-FP: the two forms on the card differ by "
            f"{forms:.3e} (tol 2e-5·max)")
        if forms > 2e-5 * float(fan[True].max()):
            raise AssertionError(f"the anterpolation forms differ: {forms}")
        ref = torch.from_numpy(ph.T.copy())
        for bf16 in (False, True):
            kw = dict(nstart=10, nsubsets=18, mm_bf16=bf16)
            cpu = sart_fast.sart_fast_convert(fan[True], g, **kw)[0]
            gpu = sart_fast.sart_fast_convert(fan[True].cuda(), g,
                                              **kw)[0].cpu()
            err, scale = float((cpu - gpu).abs().max()), float(cpu.max())
            psnr = 10 * math.log10(float(ref.max()) ** 2
                                   / float(((gpu - ref) ** 2).mean()))
            tol = (2e-3 if bf16 else 1e-3) * scale
            log(f"reference-FP: sart_fast_convert(mm_bf16={bf16}) of that "
                f"sinogram, 10 sweeps of 18 subsets: card vs CPU max |diff| "
                f"{err:.3e} (tol {tol:.3e}); PSNR against the phantom "
                f"{psnr:.2f} dB (floor 17 dB: the JAX fast path gives "
                f"17.98 dB on this phantom and scanner)")
            if not (torch.isfinite(gpu).all() and err <= tol
                    and psnr >= 17.0):
                raise AssertionError(f"64² convert (mm_bf16={bf16}): card "
                                     f"vs CPU {err}, PSNR {psnr}")
    used = {k: _build.LAUNCHES[k] - before[k] for k in before}
    log(f"reference-FP: card launches {used}")
    for k in ("fp_shift_deposit", "anterp_taps", "os_sart_sweep",
              "os_sart_sweep_bf16"):
        if used[k] <= 0:
            raise AssertionError(f"reference-FP skipped {k}")


def _example():
    """examples/synthetic_e2e_torch.py as a module."""
    path = osp.join(osp.dirname(osp.abspath(__file__)), "examples",
                    "synthetic_e2e_torch.py")
    spec = importlib.util.spec_from_file_location("synthetic_e2e_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_metric_file(path, want_counts, names):
    """metric.json at ``path``: for each mode the number of iterations
    scored, each with every metric finite. Returns the dict."""
    with open(path) as f:
        m = json.load(f)
    for mode, count in want_counts.items():
        for name in names:
            vals = [v for k, v in m[mode].items()
                    if k.startswith(name + "_iter_") and not
                    k.endswith("_std")]
            if len(vals) != count or not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"{path}: {mode}/{name}: {vals} "
                                     f"(expected {count} finite values)")
    return m


def phase_engine(seed: int):
    """The example's steps at full width from files on disk: corpus,
    checkpoints, ``ProgressiveDomainDenoiser(...).fit()`` in test_prog
    mode. Returns the launches of that run, those of the FBP slice that
    follows through update_opt, and bp_shift_accumulate's calls in it."""
    import torch
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import fbp_fast, sart_fast

    ex = _example()
    names = ["psnr", "ssim", "fsim", "vif", "nqm"]
    n_slices = 2
    with tempfile.TemporaryDirectory(prefix="ipdm_engine_") as out:
        sart_fast._SPLANS.clear()     # a user's first run builds the plans
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        ex.build_dataset(out, n_slices, 512, DOSE, seed=seed)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        cfg = dict(ART_SLICE_OPT, mode="test_prog", run_name="chip_smoke",
                   device="cuda", seed=seed, metrics=names, test_numbers=0,
                   save_it_state_proj=True, save_it_state_img=False,
                   **ex.dataset_paths(out))
        ckpt_dir = ex.write_checkpoints(out, IPDMConfig(**cfg), seed=seed)
        opt = IPDMConfig(resume_epochs_img=1, resume_epochs_proj=1,
                         load_img_model_path=ckpt_dir,
                         load_proj_model_path=ckpt_dir, **cfg)
        t0 = time.perf_counter()
        eng = ProgressiveDomainDenoiser(opt, result_save_path=out)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        for domain, model in (("img", eng.img_model),
                              ("proj", eng.proj_model)):
            saved = torch.load(osp.join(ckpt_dir, f"{domain}_model-1"),
                               weights_only=True)
            init = build_unet(opt, domain, device="cuda").state_dict()
            state = model.state_dict()
            same = all(torch.equal(state[k].cpu(), v)
                       for k, v in saved.items())
            fresh = all(torch.equal(state[k], init[k]) for k in state)
            if not same or fresh or state.keys() != saved.keys():
                raise AssertionError(f"{domain}_model-1 was not loaded "
                                     f"(equals the file: {same}, equals a "
                                     f"new model: {fresh})")
        t0 = time.perf_counter()
        eng.fit()
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"engine: corpus of {n_slices} slices 512² (phantom → "
            f"project_fast → add_noise dose {DOSE} → OS-SART 4 sweeps) "
            f"{t_build:.3f} s; engine built and 2 checkpoints loaded "
            f"{t_init:.3f} s; fit() {t_fit:.3f} s; launches {launches}; "
            f"peak memory {peak:.2f} GiB")
        missing = [k for k in ENGINE_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by the engine's "
                                 f"run: {missing}")
        counts = dict(LDCT=1, deProj=4, deProg=1)
        root = osp.join(eng.save_root_path, "Save_Iter_0")
        for i in range(n_slices):
            m = _check_metric_file(
                osp.join(root, "P001", f"{i:04d}", "metric.json"), counts,
                names)
            log(f"engine: slice {i:04d}: LDCT " + ", ".join(
                f"{nm} {m['LDCT'][nm + '_iter_0']:.4f}" for nm in names)
                + f"; deProj iter 4 psnr {m['deProj']['psnr_iter_4']:.4f}; "
                f"deProg psnr {m['deProg']['psnr_iter_1']:.4f} ssim "
                f"{m['deProg']['ssim_iter_1']:.4f}")
        agg = _check_metric_file(osp.join(root, "metric.json"), counts,
                                 names)
        ld = agg["LDCT"]["psnr_iter_0"]
        log(f"engine: aggregate LDCT PSNR {ld:.4f} dB (std "
            f"{agg['LDCT']['psnr_iter_0_std']:.4f}), deProg PSNR "
            f"{agg['deProg']['psnr_iter_1']:.4f} dB (random weights: it "
            f"need not beat the low dose)")
        if not 15.0 < ld < 60.0:
            raise AssertionError(f"LDCT PSNR {ld} dB outside 15-60 dB")
        if not osp.exists(osp.join(eng.logger.models_save_dir,
                                   "option.json")):
            raise AssertionError("option.json was not written")
        tm = eng.timer
        log(f"engine: [phases] {tm.report()}")
        per = {k: tm.totals[k] / n_slices for k in tm.totals}
        denoise = per["proj_stage+convert"] + per["img_stage"]
        log(f"engine: s/slice of the test loop over {n_slices} slices (the "
            f"first builds the OS-SART plan): denoise {denoise:.4f} "
            f"(proj stage + convert {per['proj_stage+convert']:.4f}, img "
            f"stage {per['img_stage']:.4f}), metrics on the host "
            f"{per['metrics']:.4f} (6 images × 5 metrics), saving "
            f"{per['save']:.4f}, loading {per['load']:.4f}; fit() "
            f"{t_fit / n_slices:.4f}")

        # one more slice through update_opt: FBP with the default
        # save_it_state_proj=False, so one iteration is converted and the
        # fast FBP backprojects a single sinogram
        eng.update_opt(dict(convertor="FBP", save_it_state_proj=False,
                            ultra_img_denoise=False,
                            metrics=["psnr", "ssim"], test_numbers=1))
        _build.reset_launches()
        t0 = time.perf_counter()
        with Recorder(fbp_fast, "bp_shift_accumulate") as bp1:
            eng.test(1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fbp_one = dict(_build.LAUNCHES)
        psnr = eng.metric_total["deProg"]["psnr_iter_1"]
        log(f"engine: update_opt → FBP, one converted iteration: one slice "
            f"{dt:.3f} s, deProg PSNR {psnr:.4f} dB, launches {fbp_one}")
        if (fbp_one["bp_shift_accumulate"] != len(bp1.calls)
                or not bp1.calls or not math.isfinite(psnr)):
            raise AssertionError(f"FBP, one converted iteration: "
                                 f"bp_shift_accumulate launched "
                                 f"{fbp_one['bp_shift_accumulate']} times, "
                                 f"{len(bp1.calls)} recorded, PSNR {psnr}")
    return launches, fbp_one, bp1.calls


def phase_kernels_bp1(calls, norm_calls, reps):
    """bp_shift_accumulate on the inputs the engine's single-sinogram FBP
    gave it, against its plain version and the batched kernel at B=1;
    then, outside the row's means, on the first and the last of the
    OS-SART norms' calls (V=16, one signal per view). Returns the row of
    the kernels JSON line."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    rows, stats, tag = [], [], "kernels-BP1"
    norms = [((a[0][:, 0].contiguous(),) + tuple(a[1:]), kw)
             for a, kw in (norm_calls[0], norm_calls[-1])]
    with torch.inference_mode():
        for i, (args, kw) in enumerate(list(calls) + norms):
            Q2, s0, s1, fr, n = args
            Q = Q2[:, None].contiguous()
            got = shift.bp_shift_accumulate(*args)
            want = shift.bp_shift_accumulate_plain(Q, s0, s1, fr, n)[0]
            batched = shift.bp_shift_accumulate_batched(Q, s0, s1, fr, n)[0]
            torch.cuda.synchronize()
            # f32 sums over the views in another order
            atol = 1e-5 * float(want.abs().max())
            ok, err = _within(got, want, 1e-4, atol)
            same = float((got - batched).abs().max())
            if not ok or same != 0.0:
                raise AssertionError(f"bp_shift_accumulate disagrees: max "
                                     f"|diff| {err}, from the batched "
                                     f"kernel {same}")
            V, L = Q2.shape
            s = dict(err=err, **bound_ms(
                4 * (V * L + 3 * V * n + n * n), 4 * V * n * n, F32_FLOPS),
                ms=cuda_ms(lambda: shift.bp_shift_accumulate(*args), reps),
                plain_ms=cuda_ms(lambda: shift.bp_shift_accumulate_plain(
                    Q, s0, s1, fr, n), 5))
            log(f"{tag}: bp_shift_accumulate V={V} L={L} n={n}: max |diff| "
                f"{err:.3e} (tol {atol:.2e} + 1e-4·|plain|), from the "
                f"batched kernel {same:.1e}; {s['ms']:.4f} ms, plain "
                f"{s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms"
                + ("" if i < len(calls) else " (a norms call: not in the "
                   "row)"))
            if i < len(calls):
                stats.append(s)
        summarise(rows, tag, "bp_shift_accumulate",
                  "ipdm_tpu_torch/csrc/bp_shift.cu",
                  "ipdm_tpu/ops/pallas/shift.py:193", stats, False)
    return rows


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
                         FBP_KERNELS, 90, n_timed=1)
    art_calls, per_plan = phase_record_art(ld_proj)
    rows += phase_kernels_art(art_calls, REPS)
    phase_reference_art(SEED)
    art, warm = phase_slice("ART", ART_SLICE_OPT, models, ld_proj, SEED,
                            ART_KERNELS, 105, n_timed=2, fresh_plan=True)
    fp_calls, fp_run, bf16_run = phase_record_fp(SEED)
    rows += phase_kernels_fp(fp_calls, art_calls, REPS)
    phase_reference_fp(SEED)
    del models
    eng_run, fbp_one, bp1_calls = phase_engine(SEED)
    rows += phase_kernels_bp1(
        bp1_calls, art_calls["bp_shift_accumulate_batched"], REPS)
    # each path's run had the counters set to 0 just before it and read
    # just after. A kernel's ``launches`` is its count in the ART slice's
    # main-path run (rows of the earlier slices), or in the run of this
    # slice that drives it: the engine's run from files (corpus and
    # fit()), the batched project_fast, the bf16 convert, or the engine's
    # FBP slice that follows through update_opt
    own = {"fp_shift_deposit": eng_run,
           "fp_shift_deposit_batched": fp_run,
           "bp_shift_accumulate": fbp_one,
           "os_sart_sweep_bf16": bf16_run}
    for row in rows:
        name = row["name"]
        row["launches"] = own.get(name, art)[name]
        row["launches_per_warm_slice"] = warm[name]
        row["launches_fbp"] = fbp[name]      # the FBP main-path run
        row["launches_engine"] = eng_run[name]   # corpus + fit(), 2 slices
        row["launches_project_fast"] = fp_run[name]
        if name in ("fp_plane_deposit", "anterp_taps", "bp_shift"):
            # the first convert's launches less those of a warm one
            row["launches_per_plan"] = per_plan[name] - warm[name]
        log(f"kernels: {name}: {row['launches']} launches in its main-path "
            f"run; {art[name]} in the ART slice's (plan built in it), "
            f"{warm[name]} per warm ART slice, {fbp[name]} per FBP slice, "
            f"{eng_run[name]} in the engine's run of 2 slices, "
            f"{fp_run[name]} in the batched project_fast")
        if row["launches"] <= 0:
            raise AssertionError(f"{name} was not launched in its "
                                 f"main-path run")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

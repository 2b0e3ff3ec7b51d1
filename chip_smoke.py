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
   settings (proj UNet 2000×912 and img UNet 512², bf16 activations, seeded
   random weights; 3×15 proj steps at λ=0.5, η=0.4; batched FBP of the four
   kept iterations; sharpen 70; 3×15 img steps at λ=0.45, η=0.7): s/slice
   after a warm-up slice, the launch count of every kernel (each > 0),
   output shape and finiteness, peak memory; two more timed slices; one
   slice under torch.profiler: device time by kernel and the idle share;
7. the ``kernels`` JSON line, the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero when no CUDA device is present. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

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
SHARPEN = 70  # bench.py's FBP-mode sharpen strength
SEED = 0      # weights, inputs and noise
REPS = 20     # timed launches per kernel measurement


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

    def summarise(name, source, replaces, stats, library):
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
        log(f"kernels: {name}: {n} main-path calls, mean per launch "
            f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {bound_by}"
            + (f", library {row['library_ms']:.4f} ms" if library else "")
            + f"), max |diff| {row['max_abs_err']:.3e}")

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
        summarise("planar_unit", "ipdm_tpu_torch/csrc/planar_unit.cu",
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
        summarise("flash_attn", "ipdm_tpu_torch/csrc/flash_attn.cu",
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
        summarise("bp_shift", "ipdm_tpu_torch/csrc/bp_shift.cu",
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


def phase_slice(models, ld_proj, seed: int):
    """The full-width FBP-mode slice: warm-up, then the timed main-path
    run with the launch counters read around it, two more timed slices,
    and one slice under torch.profiler (device time by kernel, and the
    device's idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
    from ipdm_tpu_torch.ops.cuda import _build

    proj_model, img_model = models

    def run(s):
        gen = torch.Generator(device="cuda").manual_seed(s)
        return progressive_denoiser(SLICE_OPT, proj_model, img_model,
                                    ld_proj, gen, sharpen_num=SHARPEN)

    t0 = time.perf_counter()
    run(seed + 1)
    torch.cuda.synchronize()
    log(f"slice: warm-up slice {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = run(seed + 2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(out).all())
    log(f"slice: {dt:.4f} s/slice (the main-path run), 90 UNet evals, "
        f"launches {launches}, output {tuple(out.shape)} {out.dtype} "
        f"finite={finite} mean {float(out.mean()):.5f}, peak memory "
        f"{peak:.2f} GiB")
    if tuple(out.shape) != (1, 512, 512, 1) or not finite:
        raise AssertionError(f"slice output {tuple(out.shape)} "
                             f"finite={finite}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    times = [dt]
    for i in range(2):
        t0 = time.perf_counter()
        run(seed + 3 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"slice: s/slice over 3 slices {[round(t, 4) for t in times]}, "
        f"mean {sum(times) / 3:.4f}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(seed + 5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    mean = sum(times) / 3
    log(f"profile: one slice, {wall:.4f} s wall under the profiler; "
        f"device kernel time {busy:.4f} s = {100 * busy / mean:.1f}% "
        f"of the unprofiled {mean:.4f} s/slice (idle "
        f"{100 * (1 - busy / mean):.1f}%)")
    for e in kernels[:25]:
        log(f"profile: {dev_us(e) / 1e3:10.3f} ms {e.count:7d}x  "
            f"{e.key[:100]}")
    return launches


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
    launches = phase_slice(models, ld_proj, SEED)
    for row in rows:
        row["launches"] = launches[row["name"]]
        log(f"kernels: {row['name']}: {row['launches']} launches per slice, "
            f"~{row['launches'] * row['ms']:.2f} ms of kernel time per slice")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

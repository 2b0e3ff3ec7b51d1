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
   (bytes over 3.35 TB/s or operations over the peak rate of their type:
   planar_unit's f32 multiply-adds at the f32 rate in both dtypes). Flash
   prints one line per recorded shape (T = 7125 from the proj UNet,
   T = 4096 from the img UNet) with its time, SDPA's and the bound, and
   its row carries them under ``shapes``; then flash at three ragged token
   counts (4097, 4159, 7125) on seeded inputs where an unmasked key past T
   would dominate, beside a planted unmasked control that must fail; and
   planar_unit at ragged widths, O > 16 and misaligned views, both dtypes;
   grad — one proj UNet eval (2000×912) and one img UNet eval (512²) at
   B = 1, bf16 activations, then loss.backward(): every parameter gets a
   finite gradient through planar_unit's and flash_attention's
   autograd.Functions (their count upstream of a kernel call printed),
   flash's backward launching the flash_bwd_dq / flash_bwd_dkv kernels
   (their inputs recorded for kernels-train); a planted control with the
   kernels called outside the Functions must leave parameters without
   one; a small f32 UNet's gradients on the card against the CPU's;
   forward + backward time beside the forward, and beside forward + the
   recomputed plain backward that the kernels replace;
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
   inputs (the sweep on the last sweep of each drive, where x ≠ 0), each
   launched twice on the same inputs (the results must be bit-equal);
   the deposit through all three of its wrappers (bit-equal) with one
   row dropped from one band as a planted fault, anterp_taps with its
   heaviest tap dropped, each timed on the device and through its wrapper;
   beside the sweep two planted faults its tolerance must see (its last
   subset dropped; one tile's row range cut short by one live row), and
   its profile split: device µs per launch of the FP and the BP kernel and
   the idle time between its launches; bp_shift on the OS-SART norms'
   calls (V=16, B=1), timed into bp_shift's row; every bp_shift check,
   here and in kernels, beside a planted fault (one view's s1 moved by
   one bin);
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
   slice, peak memory, one profiled slice; then slice-ART-f32, the same
   slice at the shipped test preset's dtype (f32 activations, both UNets
   built from the f32 options, cuDNN in TF32 as main_torch.py runs it):
   its main-path run, 2 warm slices, the profiled slice with the flash
   kernels' launches and device ms, and the f32 flash forward
   (csrc/flash_attn.cu, three bf16 passes on wgmma) on that run's q, k, v
   at T = 7125 and 4096 against the plain version (the f32 rule, the lse
   by lse_check, bit-equal repeats), timed beside SDPA f32, which it must
   not be slower than;
   exact — the reference's own reconstructor (plain PyTorch) at the
   SIEMENS geometry: the footprint pair's adjointness ⟨FP x, y⟩ =
   (1/dr)·⟨x, BP y⟩ on four views, beside a BP with one footprint bin
   dropped that must miss it; the exact FP of a 512² phantom (ms, a
   repeat's max |diff|) and its scatter-add through index_add_ and
   index_put_(accumulate=True), with and without deterministic
   algorithms (repeats bit-equal or not, ms); fbp_convert and recons
   (nstart 10, 40 subsets) of that one sinogram: ms, peak memory, finite,
   recons ≥ 0, PSNR against the phantom in the recons orientation, two
   recons runs' max |diff|; forward_project, fbp_convert and recons at
   64² on the card against the CPU, within 1e-3 of their range; one ART
   slice with exact_art (the footprint OS-SART of the four kept
   iterations): s/slice and its stage split;
   slice-DDIM — the shipped test preset (Config/Mayo-Config/
   test_progressive_option.json, f32) with sparse (DDIM) sampling in
   both domains: UNet evals per slice (counted), the main-path run with
   its launches (planar_unit, the f32 flash forward, the sweep and
   anterp_taps each > 0), warm slices and their split, the profiled
   slice's device time and idle share, peak memory; then kernels-DDIM:
   planar_unit (f32), the f32 flash forward, the sweep at B = 3 (the
   three kept iterations; beside B = 4's time per image) and anterp_taps
   on that path's recorded inputs against their plain versions;
11. record-FP — one ``project_fast`` of two 512² phantoms at the SIEMENS
   scanner (natural Kf = 2, 500 views per drive) with the kernel wrappers'
   inputs recorded, its launches, its device time; then one
   ``sart_fast_convert(..., mm_bf16=True)`` of four full-width sinograms
   (those two and their low-dose versions; nstart=10, 40 subsets) with
   its launches, beside the f32 convert of the same four; the f32
   convert's PSNR against the phantoms scored both ways (peak = max μ,
   and the engine's miu2pixel with data_range 1), also for the engine
   corpus's 4 sweeps of 18 subsets;
12. kernels-FP — on those inputs fp_shift_deposit_batched, fp_shift_deposit
   (each item) and fp_plane_deposit against the plain deposit and against
   each other, with the planted dropped row, and anterp_taps at Wt = 6
   with its planted dropped tap; the bf16 mode of os_sart_sweep
   on the last sweep of each drive against its plain version, with its
   distance from the f32 sweep, the repeat check and its profile split;
13. reference-FP — at 64², ``project_fast`` on the card against the CPU,
   both anterpolation forms, then ``sart_fast_convert`` of that sinogram
   back to an image, f32 and bf16 sweeps, with its PSNR against the
   phantom (a physics check);
13b. unfused — the unfused OS-SART and the unfolded view set at full
   width: four random-ellipse phantoms (512²) projected by project_fast,
   then ``sart_fast_convert`` (10 sweeps of 40 subsets) fused and folded
   (the ART slice's), ``fused=False`` (the natural Kf = 2 plan: 80 subset
   branches of 12-13 views, each an fp_plane_deposit and a
   bp_shift_accumulate_batched call per sweep), ``fold=False`` (63 fused
   subsets per drive) and ``fused=False, fold=False`` (24-26 views a
   branch), each with its plan built in the run and its launches counted
   around it; every deposit and BP call of each unfused convert's last
   sweep, every anterp_taps call (the resample onto the two-plane fine
   grids and nt_full) and every norms call, and the unfolded fused
   convert's last sweep, against the plain versions at their rules, each
   beside a planted fault (a dropped row, one view's s1 moved by one bin,
   a dropped tap, a dropped subset and a cut row range) that must fail;
   two runs bit-equal; the plan, norms and convert times; the images
   against each other at 10 sweeps of 40 subsets and at 8 and 4 of 18
   (gated: the unfused sweep folded vs unfolded > 30 dB at 8 and 4 of
   18, and > 90 dB at 10 of 40, where the two are the same sums; printed
   beside the JAX package's 64² floors: unfused vs fused, the fused sweep
   folded vs unfolded) and against the phantoms at 2, 4 and 10 sweeps;
   the unfused convert at 64² on the card against the CPU;
14. engine — the steps of examples/synthetic_e2e_torch.py at full width
   in a temporary directory: a corpus of two slices (phantom →
   project_fast → add_noise at dose 0.25 → OS-SART), two checkpoints
   written from seeded weights, then
   ``ProgressiveDomainDenoiser(IPDMConfig(mode="test_prog", ...)).fit()``
   with the ART settings and all five metrics: checkpoints loaded, every
   kernel of the path launched, metric.json per slice and in aggregate,
   the engine's phase times; then one more slice through ``update_opt``:
   FBP with one converted iteration, which backprojects a single sinogram
   through bp_shift_accumulate, with that wrapper's inputs recorded; the
   corpus's os_sart_sweep calls are recorded too; figures — fit() with
   display_result on one slice of that corpus: progressive.png written,
   and every PSNR / SSIM drawn on it equal to the slice's metric.json
   (where matplotlib cannot be imported, a line says the phase did not
   run and why);
15. kernels-corpus — os_sart_sweep on the corpus's last sweep of each drive
   (B = 1) against its plain version, with the repeat check;
   kernels-BP1 — bp_shift_accumulate on the recorded inputs (V=500,
   n=512) against its plain version and the batched kernel at B=1, and
   beside the row on two of the OS-SART norms' calls (V=16);
16. train — ``ProgressiveDomainDenoiser(...).fit()`` in train_img and
   then train_proj mode at the shipped train presets' widths and dtype
   (f32) on the engine phase's corpus: 10 steps each, checkpoints and
   test(it) every 5 steps on one slice; each step's loss (finite), warm
   s/step, peak memory of a step, the kernels' launches per step (f32
   flash forward, both flash backward kernels, planar_unit in the proj
   UNet: each > 0), the checkpoint files and scalars.jsonl lines; a
   resume from optimizer-1 whose Adam state must equal the file's;
17. kernels-train — the f32 flash forward on the train runs' recorded
   q, k, v (T = 4096, 7125) as in slice-ART-f32, with f32
   ragged checks and the unmasked control; flash_bwd_dq and
   flash_bwd_dkv on the recorded backward inputs (f32 from the train
   runs, bf16 from the grad phase) against attention_bwd_plain (f32 on
   the plain forward's out and lse, bf16 on the kernel's; bf16:
   2e-2·max|plain| + 2e-2·|plain| per tensor; f32: 1e-4·max|plain| +
   1e-3·|plain|), two launches bit-equal, beside a planted control with
   D dropped from dS that must fail; the forward kernel's out and lse on
   those inputs against the plain forward's (out at the forward's rule;
   lse to a per-row bound from the rounding of the scores, beside a
   planted control with the lse in log2 units that must fail); the
   ragged T = 4097 and T = 7125 backward
   and lse in both dtypes (f32 against the plain version in f64, with the
   f32 plain as a second witness) beside a planted control with the last
   key tile unmasked; the kernels' ms, the plain backward's, the
   recomputed backward's and SDPA forward + backward's, with the bound of
   the body that ran (bf16 products on wgmma; f32 as three bf16 passes)
   and, for f32, the CUDA-core bound of the same products;
18. mesh — ``parallel/mesh.py`` with 2 ranks of gloo on the one card
   (NCCL refuses two ranks on one device; spawned after this process
   built the kernels; f32, cuDNN TF32 off), each sharded result against
   the unsharded one: the img train preset's data-parallel step (2 DDP
   steps, global batch 2: losses, the first step's gradients, both
   ranks' params alike), the H-sharded eval of the img UNet at 512² and
   the proj UNet at 2000×912 (max|diff| ≤ 1e-4 of max|unsharded|; each
   rank's planar_unit and f32 flash launches > 0; each planar_unit call
   of each rank's banded evals, on its halo'd band, against the plain
   version at the f32 rule, beside a planted control with the halo row
   dropped that must fail), the view-sharded FBP at 2000 views and the
   FP, each with its time beside the unsharded one (two ranks on one
   card measure no scaling; the train step also 2 warm steps beside one
   process's at B = 2 and B = 1); then ``fit()`` of
   train_img with mesh_shape [1, 1] for 2 steps in a 1-rank NCCL group
   that the engine joins from torchrun's variables;
   quality — the port trained on the card from seeded weights, through
   examples/synthetic_e2e_torch.py's steps, in two runs. The contract of
   tests/test_quality.py: a 16-slice 64² corpus built on the card,
   train_img and train_proj at SMALL_ARCH for 200 iterations (12 epochs
   of 16 slices at batch 1), test_prog on 4 slices with the FBP
   convertor (gated: deProg > LDCT + 1 dB, deProj > LDCT − 3 dB) and
   with the ART convertor on the same checkpoints (printed). Then full
   width, at docs/PERF.md's full-scale demonstration's settings: an
   8-slice 512² corpus on the SIEMENS scanner built by FBP, FULL_ARCH
   UNets trained 100 iterations, test_prog on 4 slices with FBP (gated
   the same). Each run prints its PSNR / SSIM beside the JAX package's
   reading at its settings, its seconds by step, peak memory and
   launches (each kernel of its path > 0);
   ablations — examples/ablations_torch.py's main at the SIEMENS
   scanner's full size (``--size 512``: 512² images, 2000×912
   sinograms; the studies' fixed UNets, whose middle attention runs the
   f32 flash kernels at head dim 8 over 128² and 500×228 tokens; depth
   cut in --n 4, --iters 8, --test-slices 1): all six studies in main's
   order, each study's JSON, seconds and launches, peak memory; the
   run's head-dim-8 flash forward and backward, planar_unit,
   os_sart_sweep and fp_shift_deposit each launched; then at 32², zero
   sampler noise, f32 with TF32 off, the five engine studies on one card
   engine and one CPU engine from the same checkpoints, in main's order:
   every float within 1e-3 relative, each histogram within an L1
   distance of 1% of the pixel count;
   wide — the shipped test preset (f32) with model_channels_img and
   model_channels_proj at 128 (head dim 128: the hd-128 instance), 96
   (96, zero-padded onto 128) and 48 (48, onto 64), seeded random
   weights: per width a warm ART slice through progressive_denoiser
   (s/slice, peak memory, flash launches by instance), the f32 forward
   on its recorded q, k, v against the plain version (with a planted
   fault of the padding at 96 and 48); then 3 fit() steps each of
   train_img and train_proj at width 128 (f32, B = 1, remat, the engine
   phase's corpus), the hd-128 backward pair on their recorded inputs;
   flash-hd — (after kernels-train) the flash forward (bf16, f32) and
   both backward kernels at head dims 8, 16, 32 and 128 and at the
   padded 24, 48 and 96, T = 4097 and 7125,
   on the ragged inputs (q, k scaled so live scores stay ≈ −8) at the
   main path's rules, beside the planted controls of flash_ragged and
   bwd_ragged; then the f32 head-dim-8 kernels at T = 16 384 and
   114 000 and the head-dim-128 ones at 7125 and 16 384 (their chained
   f32 sums) against a plain forward and backward over query blocks in
   f64 (out at the f32 rule, the lse within lse_check's bound, dq, dk,
   dv at the f32 rule plus the f64 witness allowance), two launches
   bit-equal, beside planted controls (at head dim 8 the pad columns
   read from the next row, the lse in log2 units, D dropped); each
   call's ms, its bound (products or exp2, whichever is longer) and
   SDPA's ms;
   graft — __graft_entry_torch__.py: entry()'s step on the card against
   the CPU at zero noise, then dryrun_multichip(2) on two gloo ranks
   that share the card;
   multihost — scripts/multihost_dryrun_torch.py: two processes with
   torchrun's variables join through the engine's _join_mesh (gloo,
   both on cuda:0) and pass its four checks;
19. the ``kernels`` JSON line (the mesh phase's launches under
   ``launches_mesh``, with planar_unit's max |diff| on the bands; the
   unfused phase's under ``launches_unfused`` / ``launches_unfolded``,
   with its checked shapes under ``shapes_unfused``; the quality
   phase's under ``launches_quality`` and ``launches_quality_full``;
   the ablations phase's under ``launches_ablations``; the head-dim-8
   f32 flash rows, the head-dim-128 f32 rows of the wide phase (their
   long-T numbers under ``shapes_long``, the padded widths under
   ``padded``), and every flash row's ``head_dims``),
   the nvidia-smi line, and the
   last line ``{"ok": true, "device": {...}}``.

It exits non-zero when no CUDA device is present. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import importlib.util
import itertools
import json
import math
import os
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


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the report, after the script's seconds so far (where
    the 1200 s budget goes)."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {msg}", flush=True)


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
    arguments (the first ``limit`` calls, all by default; with ``key``,
    only the first call of each ``key(args)``; with ``tail``, the last
    ``tail`` calls), for as long as the ``with`` block runs."""

    def __init__(self, module, name, limit=None, key=None, tail=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = [] if tail is None else collections.deque(maxlen=tail)
        self.limit = limit
        self.key, self.keys = key, set()

    def __enter__(self):
        setattr(self.module, self.name, self._record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def _record(self, *args, **kw):
        if self.key is not None:
            k = self.key(args)
            if k not in self.keys:
                self.keys.add(k)
                self.calls.append((args, kw))
        elif self.limit is None or len(self.calls) < self.limit:
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
    if all("device_ms" in s for s in stats):
        row["device_ms"] = sum(s["device_ms"] for s in stats) / n
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
    from ipdm_tpu_torch.ops.cuda import attention, planar

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pu_calls, fa_calls, bp_calls = calls
    rows = []

    with torch.inference_mode():
        # planar_unit: bf16 within one bf16 rounding of the plain version
        # (both sum in f32, in another order), f32 to 1e-4 (f32 units run
        # in the reference phase). Its operations are f32 multiply-adds in
        # either dtype (on the TPU and on the card), so the bound counts
        # them at the f32 rate; the same count at the bf16 tensor-core
        # rate is printed once beside it, for comparison with older logs
        stats = []
        bf16_rate_ms = []
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
            bf16_rate_ms.append(max(bound_ms(nbytes, flops,
                                             BF16_FLOPS).values()))
            s = dict(err=err, **bound_ms(nbytes, flops, F32_FLOPS),
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
        log(f"kernels: planar_unit: bound at the f32 rate "
            f"{rows[-1]['bound_ms']:.4f} ms (at the bf16 tensor-core rate, "
            f"as counted before: {sum(bf16_rate_ms) / len(stats):.4f} ms)")
        planar_ragged()

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
        # the row's means weigh each shape by its launches; per shape:
        rows[-1]["shapes"] = [
            dict(T=k[1], launches_per_record=sum(
                tuple(a[0].shape) == k for a, _ in fa_calls),
                 ms=v["ms"], library_ms=v["library_ms"],
                 bound_ms=max(v["bytes_ms"], v["ops_ms"]),
                 max_abs_err=v["err"]) for k, v in seen.items()]
        flash_ragged(reps)

        # BP: f32 sums over ~500 views in another order (bp_check)
        stats = []
        for args, kw in bp_calls:
            err, over = bp_check("kernels", args, kw)
            s = dict(err=err, **_bp_stats(args, kw, reps))
            V, B, L = args[0].shape
            log(f"kernels: bp_shift V={V} B={B} L={L} n={args[4]}: max "
                f"|diff| {err:.3e} (tol 1e-5·max|plain| + 1e-4·|plain|); "
                f"two launches bit-equal; one view's s1 moved by one bin: "
                f"{over:.1f}× the tolerance; {s['ms']:.4f} ms (kernel "
                f"{s['device_ms']:.4f} ms on the device), plain "
                f"{s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            stats.append(s)
        summarise(rows, "kernels", "bp_shift", "ipdm_tpu_torch/csrc/bp_shift.cu",
                  "ipdm_tpu/ops/pallas/shift.py:119", stats, False)
        # the row's means are the FBP slice's calls; kernels-ART adds the
        # OS-SART norms' shape (V=16, B=1) beside them
        rows[-1]["shapes"] = [shape_entry(stats, V=V, B=B)]
    return rows


def repeat_check(label, got, again) -> None:
    """Two launches of a kernel on the same inputs give the same bits (the
    kernels sum in a fixed order, with no atomics)."""
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        diff = float((got - again).abs().max())
        raise AssertionError(f"{label}: two launches on the same inputs "
                             f"differ by {diff}")


def shape_entry(stats, **shape) -> dict:
    """One shape's means for a row's ``shapes`` list."""
    n = len(stats)
    extra = ({} if "device_ms" not in stats[0] else
             dict(device_ms=sum(s["device_ms"] for s in stats) / n))
    return dict(shape, calls=n, ms=sum(s["ms"] for s in stats) / n, **extra,
                plain_ms=sum(s["plain_ms"] for s in stats) / n,
                bound_ms=sum(max(s["bytes_ms"], s["ops_ms"])
                             for s in stats) / n,
                max_abs_err=max(s["err"] for s in stats))


# flash attention's tolerance per activation dtype, (rtol, atol as a share
# of max|plain|): bf16 outputs of an f32 softmax round the weights at
# different points (normalised vs not); f32 sums over T terms in another
# order (the grad phase's f32 rule)
FLASH_TOL = {"bfloat16": (2e-2, None), "float32": (1e-3, 1e-4)}
SHORT = {"bfloat16": "bf16", "float32": "f32"}


def flash_tol(want, dtype_name):
    """(rtol, atol) of :data:`FLASH_TOL` for a plain output ``want``: the
    bf16 rule's atol is the absolute 2e-2 of the main-path checks."""
    rtol, share = FLASH_TOL[dtype_name]
    return rtol, (2e-2 if share is None else
                  share * float(want.float().abs().max()))


# MUFU.EX2 on an H100 SXM: 16 a clock on each of the 132 SMs at the
# 1.98 GHz boost clock (the softmax's exp2 in the flash kernels)
EXP2_PER_S = 16 * 132 * 1.98e9


def flash_bound(BH, T, hd, dtype_name, kind) -> float:
    """The least time of a flash kernel on the card, in ms: the larger of
    the function's products (``kind`` fwd 2, dq 3, dkv 4 of 2·T²·hd flops
    a head, three bf16 passes in f32) at the bf16 tensor-core rate, its
    T² exp2 a head on the special-function units, and its bytes (each
    input read once, each output written once) over the memory rate. The
    kernels run head dim 8 at 16 columns, twice the products counted
    here: that work is a gap from the bound."""
    f32 = dtype_name == "float32"
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = products * 2.0 * T * T * hd * BH * (3 if f32 else 1)
    tensors = {"fwd": 4, "dq": 6, "dkv": 6}[kind]
    nbytes = tensors * BH * T * hd * (4 if f32 else 2)
    return max(flops / BF16_FLOPS, T * T * BH / EXP2_PER_S,
               nbytes / HBM_BYTES_PER_S) * 1e3


def sdpa_ms(q, k, v, scale, reps, do=None):
    """SDPA's time at [1, BH, T, hd] (forward, or forward + backward with
    ``do``) on its flash or memory-efficient kernel; None where neither
    takes the shape and dtype (the math kernel would hold the T × T
    matrix)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    BH, T, hd = q.shape
    q4, k4, v4 = (t_.detach().view(1, BH, T, hd).requires_grad_(
        do is not None) for t_ in (q, k, v))

    def run():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            if do is None:
                F.scaled_dot_product_attention(q4, k4, v4,
                                               scale=scale * scale)
                return
            with torch.enable_grad():
                o4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                    scale=scale * scale)
                torch.autograd.grad(o4, (q4, k4, v4), do.view(1, BH, T, hd))
    try:
        return cuda_ms(run, reps)
    except RuntimeError:
        return None


def flash_ragged(reps, dtype_name="bfloat16", counts=(4097, 4159, 7125),
                 hd=64, tag="kernels"):
    """The flash kernel at ragged token counts against the plain version
    at the main path's tolerance, on inputs where a key that escaped the
    mask would dominate: q ≈ +1 and k ≈ −1 plus noise, so every live score
    q·k·scale² is about −8, and v of head h has mean h + 1. A key row past
    T that TMA zero-filled would score 0, outweigh all the live keys
    together and pull the output toward 0. A planted control, the plain
    version on K and V zero-padded to whole 64-key tiles (what the kernel
    computes without its mask), must fail the same check. T = 4097 leaves
    one live key in the last key tile and one query in the last query
    tile (a stray write of that tile's dead rows would land on the next
    head's first rows, whose values differ by 1); T = 4159 (64·64 + 63) a
    last key tile one short of full; T = 7125 is the proj UNet's count
    (43 dead keys in the last tile). At a head dim hd below 64, q and k
    are scaled by a = (64 / hd)^¼, so that live scores stay ≈ −8. (A pad
    fault at hd 8 is :func:`flash_long`'s control: on these near-constant
    q and k a pad read from the next row shifts every score alike.)
    Returns one dict per T: max |diff|, the kernel's ms, SDPA's ms (None
    where it does not run) and the bound."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    a = (64 / hd) ** 0.25
    stats = []
    for T in counts:
        def rnd(mean, sd):
            return (a * (mean + sd * torch.randn(
                (4, T, hd), generator=gen, device="cuda"))).to(dtype)
        q, k = rnd(1.0, 0.25), rnd(-1.0, 0.25)
        v = rnd(torch.arange(1.0, 5.0, device="cuda").view(4, 1, 1) / a,
                0.5 / a)
        got = attention.flash_attention(q, k, v, scale)
        want = attention.attention_plain(q, k, v, scale)
        pad = torch.zeros((4, -T % 64, hd), dtype=q.dtype, device="cuda")
        unmasked = attention.attention_plain(
            q, torch.cat([k, pad], 1), torch.cat([v, pad], 1), scale)
        torch.cuda.synchronize()
        rtol, atol = flash_tol(want, dtype_name)
        ok, err = _within(got, want, rtol, atol)
        ctrl_ok, ctrl_err = _within(unmasked, want, rtol, atol)
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, scale), reps)
        lib = sdpa_ms(q, k, v, scale, reps)
        size = float(want.float().abs().mean())
        bound = flash_bound(4, T, hd, dtype_name, "fwd")
        stats.append(dict(T=T, hd=hd, dtype=dtype_name, err=err, ms=ms,
                          library_ms=lib, bound_ms=bound))
        log(f"{tag}: flash_attn ragged [4,{T},{hd}] {SHORT[dtype_name]} "
            f"(live scores ≈ −8, {-T % 64} dead keys): max |diff| "
            f"{err:.3e} (tol {atol:.2e} + {rtol:g}·|plain|, mean |plain| "
            f"{size:.3f}) {ms:.4f} ms, SDPA "
            + ("not run" if lib is None else f"{lib:.4f} ms")
            + f", bound {bound:.4f} ms; planted control without the mask: "
            f"max |diff| {ctrl_err:.3e}, "
            f"{'passes' if ctrl_ok else 'fails'}")
        if not ok:
            raise AssertionError(f"flash attention disagrees at T={T} "
                                 f"hd={hd}: max |diff| {err}")
        if ctrl_ok:
            raise AssertionError(f"the unmasked control passes at T={T} "
                                 f"hd={hd}: the check cannot see a "
                                 "missing mask")
    return stats


# planar_unit off the main path's shapes, (C, O, H, W, act, skip): W % 8
# != 0 takes the element-by-element staging and the strips' short tails,
# O > 16 the output-channel chunks; the main path's widths are all
# multiples of 8
PLANAR_RAGGED = ((1, 4, 13, 37, False, False), (8, 8, 13, 37, True, True),
                 (8, 16, 17, 13, True, False), (16, 8, 33, 70, True, True),
                 (12, 8, 33, 70, True, False), (8, 1, 17, 13, True, False),
                 (5, 20, 33, 70, True, True))


def planar_ragged():
    """planar_unit against its plain version at :data:`PLANAR_RAGGED` and
    at one width that is a multiple of 8 but with x and skip views that
    start one element past a 16-byte boundary (the kernel must fall back
    to element copies there), in f32 and bf16, seeded random inputs, at
    the main path's tolerances. Not timed and not in the row's means."""
    import torch
    from ipdm_tpu_torch.ops.cuda import planar

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(shape, dtype=torch.float32, offset=0):
        t = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, dtype=dtype, device="cuda")
        return buf[offset:].view(shape).copy_(t)

    cases = [c + (0,) for c in PLANAR_RAGGED] + [(8, 8, 40, 64, True, True,
                                                  1)]
    for C, O, H, W, act, sk, off in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd((1, C, H, W), dtype, off)
            a = 1 + 0.2 * rnd((1, C))
            bb = 0.2 * rnd((1, C))
            w = 0.3 * rnd((3, 3, C, O))
            bias = 0.2 * rnd((1, O))
            skip = rnd((1, O, H, W), dtype, off) if sk else None
            bf16 = dtype == torch.bfloat16
            rtol, atol = (2.0 ** -7, 1e-2) if bf16 else (1e-4, 1e-4)
            got = planar.planar_unit(x, a, bb, w, bias, skip, act=act)
            want = planar.planar_unit_plain(x, a, bb, w, bias, skip,
                                            act=act)
            torch.cuda.synchronize()
            ok, err = _within(got, want, rtol, atol)
            log(f"kernels: planar_unit ragged {str(dtype)[6:]} C={C} O={O} "
                f"{H}x{W} act={int(act)} skip={int(sk)}"
                + (f" (views {off} element past 16 B)" if off else "")
                + f": max |diff| {err:.3e} (tol {atol:g} + "
                f"{rtol:g}·|plain|)")
            if not ok:
                raise AssertionError(
                    f"planar_unit disagrees at C={C} O={O} {H}x{W} "
                    f"{dtype} offset {off}: max |diff| {err}")


def _kernel_params(out, model) -> set:
    """Names of the parameters upstream of a kernel call: those that the
    autograd graph behind ``out`` reaches from an input of a planar_unit
    or flash_attention Function node."""
    names = {id(p): n for n, p in model.named_parameters()}
    kinds = ("_PlanarUnitBackward", "_FlashAttentionBackward")
    seen, todo, starts = set(), [out.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ in kinds:
            starts.append(fn)
        todo.extend(f for f, _ in fn.next_functions)
    up, seen = set(), set()
    todo = [f for fn in starts for f, _ in fn.next_functions]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None and id(var) in names:
            up.add(names[id(var)])
        todo.extend(f for f, _ in fn.next_functions)
    return up


def _grad_check(model, x, t, r):
    """One eval and loss.backward() with grad on: (parameters with no
    gradient, with a non-finite one, upstream of a kernel call, launches
    of the kernels in the eval and its backward)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build

    model.zero_grad(set_to_none=True)
    before = dict(_build.LAUNCHES)
    out = model(x, t)
    up = _kernel_params(out, model)
    loss = (out.float() * r).sum()
    if loss.requires_grad:   # else no path reaches any parameter
        loss.backward()
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] - before[k] for k in
                ("planar_unit", "flash_attn", "flash_attn_f32",
                 "flash_bwd_dq", "flash_bwd_dkv")}
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    bad = [n for n, p in model.named_parameters()
           if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    return missing, bad, up, launches


def recompute_backward(ctx, grad_out):
    """The flash Function's former backward, the plain path the backward
    kernels replace: recompute attention_plain on the saved q, k, v and
    take its vector-Jacobian product. Timed beside the kernels."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    q, k, v = ctx.saved_tensors[:3]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention.attention_plain(*leaves, ctx.scale)
        grads = torch.autograd.grad(out, leaves, grad_out)
    return (*grads, None)


def phase_grad(models, ld_proj, seed: int):
    """Gradients through the hand kernels: one proj UNet eval (2000×912)
    and one img UNet eval (512²) at B = 1, bf16 activations, followed by
    loss.backward() through the flash backward kernels; every parameter
    must get a finite gradient. Beside it a planted control, the same
    check with the kernels called outside their autograd.Function (the
    bare forward), which must find parameters with no gradient; then a
    small f32 UNet's parameter gradients on the card (kernel forward)
    against the CPU's (plain); and the time of forward + backward per eval
    beside the forward alone and beside forward + the recomputed backward
    (in the same call). Returns the flash backward's recorded
    inputs, one call per UNet (T = 7125 and 4096, bf16)."""
    import torch
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.models.unet import UNetModel
    from ipdm_tpu_torch.ops.cuda import attention, planar

    proj_model, img_model = models
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = (("proj", proj_model, ld_proj.permute(0, 3, 1, 2).contiguous()),
             ("img", img_model, torch.rand((1, 1, 512, 512), device="cuda",
                                           generator=gen)))
    t = torch.full((1,), 7, dtype=torch.long, device="cuda")
    bwd_calls = []
    for name, model, x in cases:
        r = torch.randn(x.shape, device="cuda", generator=gen)
        with Recorder(attention, "flash_bwd_dq", limit=1) as rec:
            missing, bad, up, launches = _grad_check(model, x, t, r)
        bwd_calls += rec.calls
        nparam = sum(1 for _ in model.parameters())
        log(f"grad: {name} UNet {tuple(x.shape[2:])} bf16, B=1: "
            f"{nparam} parameters, {nparam - len(missing)} with a "
            f"gradient, {len(bad)} non-finite; {len(up)} upstream of a "
            f"kernel call; launches in the eval and its backward "
            f"{launches}"
            + (f"; no gradient: {missing[:8]}" if missing else "")
            + (f"; non-finite: {bad[:8]}" if bad else ""))
        ran = (launches["flash_attn"] and launches["flash_bwd_dq"]
               and launches["flash_bwd_dkv"]
               and (launches["planar_unit"] or name == "img"))
        if missing or bad or not up or not ran:
            raise AssertionError(f"grad: the {name} UNet's gradients: "
                                 f"{len(missing)} missing, {len(bad)} "
                                 f"non-finite, launches {launches}")
        # the planted control: the kernels outside their Function
        real = unet.planar_unit, unet.flash_attention
        unet.planar_unit, unet.flash_attention = (planar._forward,
                                                  attention._forward)
        try:
            cut, _, _, _ = _grad_check(model, x, t, r)
        finally:
            unet.planar_unit, unet.flash_attention = real
        log(f"grad: {name} UNet, control with the kernels called outside "
            f"their autograd.Function: {len(cut)} parameters with no "
            f"gradient (the check must see them)")
        if not cut:
            raise AssertionError(f"grad: the {name} control found every "
                                 "gradient: the check cannot see the fault")
        fwd = cuda_ms(lambda: model(x, t), 3, warmup=1)

        def step():
            model.zero_grad(set_to_none=True)
            (model(x, t).float() * r).sum().backward()

        both = cuda_ms(step, 3, warmup=1)
        kernel_bwd = attention._FlashAttention.backward
        attention._FlashAttention.backward = staticmethod(recompute_backward)
        try:
            both_recompute = cuda_ms(step, 3, warmup=1)
        finally:
            attention._FlashAttention.backward = kernel_bwd
        with torch.inference_mode():
            infer = cuda_ms(lambda: model(x, t), 3, warmup=1)
        log(f"grad: {name} UNet eval {infer:.3f} ms under inference_mode, "
            f"{fwd:.3f} ms with grad on, forward + backward {both:.3f} ms "
            f"({both / infer:.2f}× the inference eval) with the flash "
            f"backward kernels, {both_recompute:.3f} ms "
            f"({both_recompute / infer:.2f}×) with the recomputed "
            f"backward")
        model.zero_grad(set_to_none=True)

    # a small f32 UNet (planar units on its two shallow levels; its
    # attention is short, so no flash): the card's gradients against the
    # CPU's
    torch.manual_seed(seed)
    small = UNetModel(in_channels=1, model_channels=16, out_channels=1,
                      num_res_blocks=1, attention_resolutions=(4,),
                      channel_mult=(0.25, 0.5, 1, 2), num_heads=2,
                      device="cpu")
    host = np.random.default_rng(seed)
    xs = torch.as_tensor(host.random((2, 1, 64, 64), np.float32))
    rs = torch.as_tensor(host.standard_normal((2, 1, 64, 64), np.float32))
    ts = torch.tensor([3, 40])
    grads = []
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(small).to(dev)
        missing, bad, up, launches = _grad_check(
            m, xs.to(dev), ts.to(dev), rs.to(dev))
        if missing or bad or not up:
            raise AssertionError(f"grad: small UNet on {dev}: {missing} "
                                 f"{bad}")
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
    # f32 sums in another order through the UNet's layers: 1e-4 of each
    # tensor's largest entry plus 1e-3 of each entry, plus 1e-5 of the
    # model's largest gradient entry (tests/test_torch_grad.py's rule: an
    # entry whose exact value is zero, such as a time-embedding weight
    # feeding a conv whose output one-channel GroupNorm groups re-centre,
    # carries the rounding of the terms that cancel in it)
    scale = max(float(g.abs().max()) for g in grads[0].values())
    worst, where = 0.0, None
    for n, g in grads[0].items():
        tol = (1e-4 * float(g.abs().max()) + 1e-3 * g.abs() + 1e-5 * scale)
        d = (grads[1][n] - g).abs()
        over = float((d / tol).max())
        if over > worst:
            worst = over
            where = (f"{n} (max |g| {float(g.abs().max()):.3e}, max |diff| "
                     f"{float(d.max()):.3e})")
    log(f"grad: small f32 UNet 64², card (kernel forward, {launches}) "
        f"against the CPU (plain): {len(grads[0])} parameter gradients, "
        f"largest entry {scale:.3e}; the worst at {worst:.3f} of the "
        f"tolerance (1e-4·max|g| + 1e-3·|g| + 1e-5·largest), in {where}")
    if not worst <= 1.0:
        raise AssertionError(f"grad: small UNet's gradients differ: {worst} "
                             f"of the tolerance in {where}")
    return bwd_calls


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
    main-path run's and the warm slice's launch counts and the profiled
    slice's kernels as {name: (launches, device ms)}."""
    import torch
    from torch.profiler import ProfilerActivity

    from ipdm_tpu_torch.engine.denoiser import (make_convertor,
                                                progressive_denoiser)
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import sart_fast

    proj_model, img_model = models
    tag = {"FBP": "slice", "ART": "slice-ART", "ART-f32": "slice-ART-f32",
           "DDIM": "slice-DDIM"}[label]

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
    # device activity alone: the host ops' events add nothing to the
    # device time and the idle share, and their post-processing took
    # ~130 s of the script's budget per profiled slice
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(seed + 9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(ms for _, ms in kernels.values()) / 1e3
    log(f"{tag} profile: one slice, {wall:.4f} s wall under the profiler; "
        f"device kernel time {busy:.4f} s = {100 * busy / mean:.1f}% "
        f"of the unprofiled {mean:.4f} s/slice (idle "
        f"{100 * (1 - busy / mean):.1f}%)")
    for key, (n, ms) in sorted(kernels.items(), key=lambda kv: kv[1][1],
                               reverse=True)[:25]:
        log(f"{tag} profile: {ms:10.3f} ms {n:7d}x  {key[:100]}")
    return launches, warm, kernels


def device_kernels(prof) -> dict:
    """{name: (launches, device ms)} of the device activity (kernels,
    copies, sets) of a finished torch.profiler run, summed from its raw
    events: building its FunctionEvents, which key_averages() does, took
    57-75 s of the script's budget per profiled slice (tens of thousands
    of launches, run 3 of PR 16)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ms = out.get(e.name(), (0, 0.0))
            out[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    return out

# the shipped test preset's activation dtype: Config/Mayo-Config/
# test_progressive_option.json sets no compute_dtype, so it runs at the
# config's default, float32
ART_F32_SLICE_OPT = dict(ART_SLICE_OPT, compute_dtype="float32")
ART_F32_KERNELS = ("planar_unit", "flash_attn_f32", "bp_shift",
                   "fp_plane_deposit", "os_sart_sweep", "anterp_taps")
# bf16 tensor-core passes per product of csrc/flash_attn.cu's f32 body
F32_FWD_PASSES = 3


def flash_f32_check(tag, calls, reps):
    """The f32 flash forward on recorded q, k, v against the plain version
    in f32: out at the f32 rule (:func:`flash_tol`), the lse within
    1e-4·max|plain lse| and by :func:`lse_check`, two launches bit-equal
    in both; its time through the wrapper (the split pre-pass included),
    the plain version's and SDPA f32's in the same call, which it must not
    exceed; the bound of the body that runs (three bf16 passes of
    4·T²·64·BH operations at the bf16 tensor-core rate) beside the
    CUDA-core bound of the same f32 products. Returns one stats dict per
    call."""
    import torch
    import torch.nn.functional as F
    from ipdm_tpu_torch.ops.cuda import attention

    stats = []
    for args, kw in calls:
        q, k, v, scale = args
        got, lse = attention._forward(q, k, v, scale, with_lse=True)
        again, lse2 = attention._forward(q, k, v, scale, with_lse=True)
        repeat_check("flash_attn_f32", got, again)
        repeat_check("flash_attn_f32 lse", lse, lse2)
        want, plse = attention.attention_lse_plain(q, k, v, scale)
        torch.cuda.synchronize()
        rtol, atol = flash_tol(want, "float32")
        ok, err = _within(got, want, rtol, atol)
        over = float(((got - want).abs() / (atol + rtol * want.abs())).max())
        lse_err = float((lse - plse).abs().max())
        lse_ok = lse_err <= 1e-4 * float(plse.abs().max())
        del want, plse
        lse_over, lse_ctrl = lse_check(lse, q, k, scale, "float32")
        BH, T, hd = q.shape
        flops = 4 * BH * T * T * hd
        q4, k4, v4 = (t_.view(1, BH, T, hd) for t_ in (q, k, v))
        s = dict(err=err, over=over, lse_over=lse_over, T=T,
                 **bound_ms(4 * BH * T * hd * 4, F32_FWD_PASSES * flops,
                            BF16_FLOPS),
                 cuda_core_bound_ms=flops / F32_FLOPS * 1e3,
                 ms=cuda_ms(lambda: attention.flash_attention(
                     q, k, v, scale), reps),
                 plain_ms=cuda_ms(lambda: attention.attention_plain(
                     q, k, v, scale), max(2, reps // 4)),
                 library_ms=cuda_ms(
                     lambda: F.scaled_dot_product_attention(
                         q4, k4, v4, scale=scale * scale), reps))
        log(f"{tag}: flash_attn_f32 [{BH},{T},{hd}] f32 (recorded on the "
            f"main path): out at {over:.4f} of the f32 rule (max |diff| "
            f"{err:.3e}, tol {atol:.2e} + {rtol:g}·|plain|), lse max |diff| "
            f"{lse_err:.3e}, at {lse_over:.4f} of lse_check's bound "
            f"(log2-units control {lse_ctrl:.1f}×); two launches "
            f"bit-equal; {s['ms']:.4f} ms on wgmma, {F32_FWD_PASSES} bf16 "
            f"passes (bound {max(s['bytes_ms'], s['ops_ms']):.4f} ms; "
            f"{s['cuda_core_bound_ms']:.4f} ms at the f32 CUDA-core rate), "
            f"plain {s['plain_ms']:.4f} ms, SDPA f32 {s['library_ms']:.4f} "
            f"ms (the kernel at {s['ms'] / s['library_ms']:.3f}× it)")
        if not ok or not lse_ok:
            raise AssertionError(f"flash_attn_f32 disagrees at T={T}: "
                                 f"{err}, lse {lse_err}")
        if s["ms"] > s["library_ms"]:
            raise AssertionError(f"flash_attn_f32 at T={T}: {s['ms']} ms, "
                                 f"slower than SDPA f32 "
                                 f"({s['library_ms']} ms)")
        stats.append(s)
    return stats


def f32_shapes(stats) -> list:
    """The per-shape entries of the f32 forward's row."""
    return [dict(T=st["T"], ms=st["ms"], library_ms=st["library_ms"],
                 plain_ms=st["plain_ms"],
                 bound_ms=max(st["bytes_ms"], st["ops_ms"]),
                 cuda_core_bound_ms=st["cuda_core_bound_ms"],
                 max_abs_err=st["err"], rule_share=st["over"],
                 lse_bound_share=st["lse_over"]) for st in stats]


def phase_slice_f32(ld_proj, seed: int, reps: int) -> dict:
    """The ART slice at the shipped test preset's dtype, f32 activations
    (:data:`ART_F32_SLICE_OPT`), with both UNets built anew from the f32
    options and PyTorch's default precision, as ``main_torch.py`` runs it
    (cuDNN convolutions in TF32, matmuls in f32): the main-path run on a
    plan built anew, 2 warm slices with their stage split, one profiled
    slice (:func:`phase_slice`); the flash kernels' launches and device
    ms in the profiled slice; then the f32 forward on the main-path run's
    q, k, v (its first call of each shape: T = 7125 from the proj UNet,
    4096 from the img UNet) by :func:`flash_f32_check`. Returns the
    kernels JSON line's flash_attn_f32 row."""
    import torch
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.models.unet import build_unet

    torch.manual_seed(seed)
    models = (build_unet(ART_F32_SLICE_OPT, "proj", device="cuda").eval(),
              build_unet(ART_F32_SLICE_OPT, "img", device="cuda").eval())
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with Recorder(unet, "flash_attention",
                      key=lambda a: tuple(a[0].shape)) as fa:
            run, warm, prof = phase_slice(
                "ART-f32", ART_F32_SLICE_OPT, models, ld_proj, seed,
                ART_F32_KERNELS, 105, n_timed=2, fresh_plan=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    del models
    flash = {k: v for k, v in prof.items()
             if "flash_attn_kernel" in k or "split_kernel" in k}
    for k, (n, ms) in flash.items():
        log(f"slice-ART-f32 profile: flash {k[:60]}: {n} launches, "
            f"{ms:.3f} ms on the device ({ms / max(n, 1):.4f} ms each)")
    log(f"slice-ART-f32: flash_attn_f32 launches per warm slice "
        f"{warm['flash_attn_f32']} (expected 525: 225 at T = 7125, 300 at "
        f"T = 4096), in the main-path run {run['flash_attn_f32']}; flash's "
        f"device time in the profiled slice "
        f"{sum(ms for _, ms in flash.values()):.3f} ms")
    stats = flash_f32_check("kernels-ART-f32", fa.calls, reps)
    rows = []
    summarise(rows, "kernels-ART-f32", "flash_attn_f32",
              "ipdm_tpu_torch/csrc/flash_attn.cu",
              "ipdm_tpu/models/unet.py:601", stats, True)
    row = rows[0]
    row["launches"] = run["flash_attn_f32"]
    row["launches_per_warm_f32_slice"] = warm["flash_attn_f32"]
    row["shapes"] = f32_shapes(stats)
    return row


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


def phase_kernels_art(calls, reps, bp_row):
    """The three SART kernels against their plain versions on the
    recorded inputs, with their times and bounds; the sweep's repeat
    check, its planted row-range control and its profile split; bp_shift
    on a few of the norms' calls, timed into ``bp_row``'s shapes. Returns
    the rows of the kernels JSON line."""
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
        # Wt terms), in another order: the summation error bound. The
        # plan's norms deposit each drive twice on the same inputs: one
        # check per drive
        seen = set()
        stats = []
        for args, kw in calls["fp_plane_deposit"]:
            key = args[1].data_ptr()       # the drive's start table
            if key not in seen:
                seen.add(key)
                stats.append(deposit_checks("kernels-ART", args, kw, reps,
                                            ("fp_plane_deposit",))[
                    "fp_plane_deposit"])
        row("fp_plane_deposit", "ipdm_tpu_torch/csrc/fp_deposit.cu",
            "ipdm_tpu/ops/pallas/shift.py:279", stats)

        stats = [anterp_checks("kernels-ART", args, kw, reps)
                 for args, kw in calls["anterp_taps"]]
        row("anterp_taps", "ipdm_tpu_torch/csrc/anterp_taps.cu",
            "ipdm_tpu/ops/pallas/shift.py:702", stats)
        # per shape: the resample of every convert (B = 4, Wt = 2) and the
        # plan's anterpolated norms (B = 1)
        shapes = {}
        for (args, _), st in zip(calls["anterp_taps"], stats):
            shapes.setdefault((args[0].shape[1], args[2].shape[1]),
                              []).append(st)
        rows[-1]["shapes"] = [shape_entry(v, B=k[0], Wt=k[1])
                              for k, v in shapes.items()]

        # the sweep on the last sweep of each drive
        sweeps = calls["os_sart_sweep"]
        stats = [sweep_checks("kernels-ART", args, kw, reps)
                 for args, kw in sweeps[-2:]]
        S, Vp, B, _ = sweeps[-1][0][1].shape
        row("os_sart_sweep", "ipdm_tpu_torch/csrc/os_sart_sweep.cu",
            "ipdm_tpu/ops/pallas/shift.py:544", stats)
        rows[-1]["shapes"] = [shape_entry(stats, S=S, Vp=Vp, B=B)]
        args, kw = sweeps[-1]
        sweep_profile("kernels-ART", lambda: shift.os_sart_sweep(*args, **kw),
                      args[1].shape[0])

        # bp_shift on the norms' calls (V=16, B=1): the first and the last
        # of each drive, timed into the bp_shift row's shapes
        bp = calls["bp_shift_accumulate_batched"]
        half = len(bp) // 2
        stats = []
        for args, kw in (bp[0], bp[half - 1], bp[half], bp[-1]):
            err, over = bp_check("kernels-ART norms", args, kw)
            s = dict(err=err, **_bp_stats(args, kw, reps))
            V, B, L = args[0].shape
            log(f"kernels-ART: bp_shift (norms) V={V} B={B} L={L} "
                f"n={args[4]}: max |diff| {err:.3e} (tol 1e-5·max|plain| + "
                f"1e-4·|plain|); two launches bit-equal; one view's s1 moved "
                f"by one bin: {over:.1f}× the tolerance; {s['ms']:.4f} ms "
                f"(kernel {s['device_ms']:.4f} ms on the device), plain "
                f"{s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            stats.append(s)
        bp_row["shapes"].append(shape_entry(stats, V=V, B=B))
    return rows


def sweep_checks(tag, args, kw, reps, row_control: bool = True) -> dict:
    """The f32 sweep on one recorded call (a late sweep, x != 0; the first
    starts from x = 0 and its FP is all zeros) against its plain version:
    2·S dependent subset updates of f32 sums in another order, so 1e-5 of
    the largest pixel plus 1e-4 of each; two launches bit-equal. Beside it
    two planted faults the tolerance has to see: the last subset dropped,
    and one tile's row range cut short by a live row
    (:func:`row_range_control`, required unless not ``row_control``).
    Returns the call's stats."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    x, rf, inv2, frac, s0, nrmi, lam = args
    if not float(x.abs().max()) > 0:
        raise AssertionError("os_sart_sweep held on x = 0")
    want = shift.os_sart_sweep_plain(*args)
    got = shift.os_sart_sweep(*args, **kw)
    repeat_check("os_sart_sweep", got, shift.os_sart_sweep(*args, **kw))
    torch.cuda.synchronize()
    atol = 1e-5 * float(want.abs().max())
    ok, err = _within(got, want, 1e-4, atol)
    if not ok:
        raise AssertionError(f"os_sart_sweep ({tag}) disagrees: max |diff| "
                             f"{err} (tol {atol:.3e} + 1e-4·|plain|)")
    short = shift.os_sart_sweep_plain(
        x, *(a[:-1] for a in (rf, inv2, frac, s0, nrmi)), lam)
    over = sweep_over(short, want)
    log(f"{tag}: os_sart_sweep with its last subset dropped: max |diff| "
        f"{float((short - want).abs().max()):.3e}, {over:.1f}× the "
        f"tolerance at its worst pixel")
    if not over > 1.0:
        raise AssertionError(f"the sweep's tolerance does not see its last "
                             f"subset dropped ({over})")
    row_range_control(tag, args, kw, want, required=row_control)
    S, Vp, B, L = rf.shape
    n = x.shape[-1]
    live = int((inv2 != 0).any(dim=2).sum())
    nbytes = 4 * (2 * B * n * n + S * Vp * B * L + S * Vp * L
                  + 2 * S * Vp * n + S * n * n)
    flops = 8 * live * B * n * n + 2 * S * Vp * B * L + 4 * S * B * n * n
    fn = lambda: shift.os_sart_sweep(*args, **kw)
    # device time over 3 calls: their 3·(2·S + 1) launches are enqueued
    # well inside queued_ms's spin
    s = dict(err=err, **bound_ms(nbytes, flops, F32_FLOPS),
             ms=cuda_ms(fn, reps), device_ms=queued_ms(fn, 3),
             plain_ms=cuda_ms(lambda: shift.os_sart_sweep_plain(*args), 2, 1))
    log(f"{tag}: os_sart_sweep S={S} Vp={Vp} ({live} live views) B={B} "
        f"n={n} L={L} lam={lam:.4f} max|x|={float(x.abs().max()):.4f}: max "
        f"|diff| {err:.3e} (tol {atol:.2e} + 1e-4·|plain|) {s['ms']:.4f} ms "
        f"(device {s['device_ms']:.4f} ms), plain {s['plain_ms']:.4f} ms, "
        f"bound "
        f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms (bytes "
        f"{s['bytes_ms']:.4f}, operations {s['ops_ms']:.4f}); two launches "
        f"bit-equal")
    return s


def sweep_over(got, want) -> float:
    """max |got − want| over the f32 sweep's tolerance, 1e-5·max|want| +
    1e-4·|want|, at the worst pixel."""
    tol = 1e-5 * float(want.abs().max()) + 1e-4 * want.abs()
    return float(((got - want).abs() / tol).max())


def row_range_control(tag, args, kw, want, required: bool = True) -> None:
    """A planted fault the sweep's tolerance has to see: the kernel rerun
    with one tile's row range cut short by one live row (a row whose taps
    land in the tile), in the last subset, whose update reaches the output
    directly. The cut is the first or the last row of a range (only those
    can go while the range stays a range). Every such cut is first made in
    plain PyTorch (the last subset's FP without the row's taps in the
    tile, its BP, the relaxed update and the clamp) and the three whose
    output lies farthest outside the tolerance are run on the kernel. The
    best must miss the tolerance. Where no cut misses it even in plain
    PyTorch (a smooth image whose range ends lie where it is near 0) the
    control can test nothing: unless ``required``, that is printed and
    the kernel is not run."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    x, rf, inv2, frac, s0, nrmi, lam = args
    S, Vp, B, L = rf.shape
    n = x.shape[-1]
    rows = kw["row_ranges"]
    s = S - 1
    r = rows[s].long()                                   # [Vp, nt, 2]
    # the image before the last subset and that subset's update before
    # the clamp, in plain PyTorch
    xp = shift.os_sart_sweep_plain(
        x, *(a[:-1] for a in (rf, inv2, frac, s0, nrmi)), lam)
    s1 = s0[s] + 1
    T = shift.fp_plane_deposit_plain(xp.transpose(0, 1).contiguous(), s0[s],
                                     s1, 1 - frac[s], frac[s], L)
    pre = xp + lam * nrmi[s] * shift.bp_shift_accumulate_plain(
        rf[s] - T * inv2[s][:, None, :], s0[s], s1, frac[s], n)
    tol = 1e-5 * float(want.abs().max()) + 1e-4 * want.abs()
    zero = torch.zeros((), device=x.device)

    def effect(v, k, y):
        """The cut's output over the tolerance, at its worst pixel."""
        tk = torch.arange(k * shift.SWEEP_TILE,
                          min((k + 1) * shift.SWEEP_TILE, L), device=x.device)
        sy, f = int(s0[s, v, y]), float(frac[s, v, y])
        taps = sum(w * torch.where((u >= 0) & (u < n),
                                   xp[:, y, u.clamp(0, n - 1)], zero)
                   for u, w in ((tk - sy, 1 - f), (tk - sy - 1, f)))
        dq = torch.zeros((1, B, L), device=x.device)
        dq[0, :, tk] = taps * inv2[s, v, tk]             # the lost FP taps
        dbp = shift.bp_shift_accumulate_plain(dq, s0[s, v:v + 1],
                                              s1[v:v + 1],
                                              frac[s, v:v + 1], n)
        got = (pre + lam * nrmi[s] * dbp).clamp_min(0.0)
        return float(((got - want).abs() / tol).max())

    cands = sorted(((effect(v, k, int(r[v, k, end]) - end), end, v, k)
                    for v, k in torch.nonzero(r[..., 1] > r[..., 0]).tolist()
                    for end in (0, 1)), reverse=True)
    if not required and not cands[0][0] > 1.0:
        log(f"{tag}: os_sart_sweep: no cut of one row from a tile's row "
            f"range in the last subset lies outside the tolerance even in "
            f"plain PyTorch on these inputs (the farthest of {len(cands)}: "
            f"{cands[0][0]:.2f}×), so that control is not run here")
        return
    best = None
    for plain_over, end, v, k in cands[:3]:
        cut = rows.clone()
        if end == 0:
            cut[s, v, k, 0] += 1
        else:
            cut[s, v, k, 1] -= 1
        got = shift.os_sart_sweep(*args, **dict(kw, row_ranges=cut))
        over = sweep_over(got, want)
        if best is None or over > best[0]:
            best = (over, plain_over, (end, v, k,
                                       tuple(rows[s, v, k].tolist())))
    over, plain_over, (end, v, k, rng) = best
    log(f"{tag}: os_sart_sweep with one tile's row range cut short by "
        f"one live row (subset {s}, view {v}, tile {k}, range {rng}, its "
        f"{'first' if end == 0 else 'last'} row dropped; the best of the 3 "
        f"of {len(cands)} cuts farthest out in plain PyTorch, there "
        f"{plain_over:.1f}×): {over:.1f}× the tolerance at its worst pixel")
    if not over > 1.0:
        raise AssertionError(f"the sweep's tolerance does not see a row "
                             f"dropped from a tile ({over})")


def device_times(fn, calls: int) -> dict:
    """Device time of each kernel that ``calls`` calls of fn() launch,
    under torch.profiler: {kernel name: (total ms, launches)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    return {e.key: (dev_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0}


def queued_ms(fn, reps: int) -> float:
    """Device ms per call of fn() with the stream kept busy: a spin kernel
    (~10 ms) holds the queue while the host enqueues all ``reps`` calls,
    so the events time the device's own work back to back, without the
    wrapper's host time between launches (which cuda_ms includes where it
    is longer than the kernel)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def sweep_profile(tag, fn, S) -> None:
    """The sweep's device time per launch of its FP and BP kernels (the
    means over the launches torch.profiler records in 3 calls; it can drop
    some in a long process, so the count is printed) and the idle time
    between its launches: a call's device time with the queue kept busy
    (queued_ms) less S launches of each half and the wrapper's copy of x,
    over the 2·S gaps between its 2·S + 1 launches."""
    calls = 3
    call_ms = queued_ms(fn, calls)
    kern = device_times(fn, calls)
    per = {}
    for key in ("sweep_fp_kernel", "sweep_bp_kernel", "Memcpy"):
        es = [v for k, v in kern.items() if key in k]
        n = sum(c for _, c in es)
        per[key] = (sum(t for t, _ in es) / n if n else None, n)
    (fp, n_fp), (bp, n_bp), (cp, _) = per.values()
    if fp is None or bp is None:
        log(f"{tag} profile: os_sart_sweep S={S}: {call_ms:.4f} ms per call "
            f"on the device; the FP / BP split not measured (the profiler "
            f"recorded {n_fp} / {n_bp} of {S * calls} launches each)")
        return
    idle = call_ms - S * (fp + bp) - (cp or 0.0)
    log(f"{tag} profile: os_sart_sweep S={S}: {call_ms:.4f} ms per call on "
        f"the device (queue kept busy); FP {fp * 1e3:.2f} us per launch, BP "
        f"{bp * 1e3:.2f} us per launch (means over the {n_fp} / {n_bp} of "
        f"{S * calls} launches the profiler recorded), the copy of x "
        f"{(cp or 0.0) * 1e3:.2f} us; idle between launches {idle:.4f} ms a "
        f"call = {idle / (2 * S) * 1e3:.2f} us per gap, "
        f"{100 * idle / call_ms:.1f}% of the call")


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


def deposit_check(tag, args, kw):
    """fp_plane_deposit on one recorded input against the plain version at
    the summation-order bound, repeated bit-equal, and a planted fault
    (one live row dropped from one band: its two weights zeroed in the
    middle live view) that the bound must see. Returns (max |diff|, the
    check's message, the fault's worst ratio to the bound, its (view,
    row), the kernel's output)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    rows_, s0, s1, w0, w1, L = args
    n = rows_.shape[0]
    want = shift.fp_plane_deposit_plain(*args)
    absum = shift.fp_plane_deposit_plain(rows_.abs(), s0, s1, w0.abs(),
                                         w1.abs(), L)
    plane = shift.fp_plane_deposit(*args, **kw)
    repeat_check("fp_plane_deposit", plane,
                 shift.fp_plane_deposit(*args, **kw))
    err, msg = _sum_bound_check(f"fp_plane_deposit ({tag})", plane, want,
                                absum, 2 * n)
    live = (w0 != 0).any(dim=1) | (w1 != 0).any(dim=1)
    v = int(torch.nonzero(live)[int(live.sum()) // 2])
    y = n // 2
    cut0, cut1 = w0.clone(), w1.clone()
    cut0[v, y] = cut1[v, y] = 0.0
    dropped = shift.fp_plane_deposit(rows_, s0, s1, cut0, cut1, L, **kw)
    torch.cuda.synchronize()
    tol = 2 * (2 * n) * 2.0 ** -24 * absum
    over = float(((dropped - want).abs() / tol.clamp_min(1e-30)).max())
    if not over > 1.0:
        raise AssertionError(f"the deposit's bound does not see a dropped "
                             f"row ({over})")
    return err, msg, over, (v, y), plane


def deposit_bound(args, b: int) -> dict:
    """The deposit's bound at b images: each row, table and output once;
    4 flops per tap and element of the live views."""
    rows_, s0, s1, w0, w1, L = args
    n, _, W = rows_.shape
    V = s0.shape[0]
    nv = int(((w0 != 0).any(dim=1) | (w1 != 0).any(dim=1)).sum())
    return bound_ms(4 * (n * b * W + 4 * V * n + V * b * L),
                    4 * nv * n * b * W, F32_FLOPS)


def deposit_checks(tag, args, kw, reps, timed) -> dict:
    """The deposit kernel on one recorded input through its three wrappers:
    fp_plane_deposit as :func:`deposit_check` holds it (with its planted
    dropped row), fp_shift_deposit_batched and fp_shift_deposit (each
    item) bit-equal to it, every launch repeated bit-equal. For each
    wrapper named in ``timed``, the
    device time (stream held by a spin kernel), the wrapper's and the
    plain version's (fp_shift_deposit on the last item). Returns {wrapper:
    stats}."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    rows_, s0, s1, w0, w1, L = args
    n, B, W = rows_.shape
    V = s0.shape[0]
    err, msg, over, (v, y), plane = deposit_check(tag, args, kw)
    batched = shift.fp_shift_deposit_batched(*args, **kw)
    repeat_check("fp_shift_deposit_batched", batched,
                 shift.fp_shift_deposit_batched(*args, **kw))
    one = (rows_[:, B - 1].contiguous(), s0, s1, w0, w1, L)
    singles = [shift.fp_shift_deposit(rows_[:, b].contiguous(), *one[1:],
                                      **kw) for b in range(B)]
    repeat_check("fp_shift_deposit", singles[-1],
                 shift.fp_shift_deposit(*one, **kw))
    torch.cuda.synchronize()
    d8 = float((batched - plane).abs().max())
    d9 = max(float((x - plane[:, b]).abs().max())
             for b, x in enumerate(singles))
    if d8 != 0.0 or d9 != 0.0:     # one kernel, one sum order
        raise AssertionError(f"the deposits differ: batched − plane {d8}, "
                             f"single − plane {d9}")
    calls = {"fp_plane_deposit": (lambda: shift.fp_plane_deposit(*args, **kw),
                                  lambda: shift.fp_plane_deposit_plain(*args),
                                  B),
             "fp_shift_deposit_batched": (
                 lambda: shift.fp_shift_deposit_batched(*args, **kw),
                 lambda: shift.fp_plane_deposit_plain(*args), B),
             "fp_shift_deposit": (
                 lambda: shift.fp_shift_deposit(*one, **kw),
                 lambda: shift.fp_shift_deposit_plain(*one), 1)}
    out, times = {}, []
    for name in timed:
        fn, plain, b = calls[name]
        st = dict(err=err, **deposit_bound(args, b), ms=cuda_ms(fn, reps),
                  device_ms=queued_ms(fn, reps), plain_ms=cuda_ms(plain, 3))
        out[name] = st
        times.append(f"{name} (B={b}) {st['ms']:.4f} ms (kernel "
                     f"{st['device_ms']:.4f} ms on the device), plain "
                     f"{st['plain_ms']:.4f} ms, bound "
                     f"{max(st['bytes_ms'], st['ops_ms']):.4f} ms")
    nv = int(((w0 != 0).any(dim=1) | (w1 != 0).any(dim=1)).sum())
    log(f"{tag}: deposit V={V} ({nv} live) B={B} n={n} W={W} L={L}: {msg}; "
        f"fp_shift_deposit_batched and fp_shift_deposit (each item) "
        f"bit-equal to fp_plane_deposit, every launch repeated bit-equal; "
        f"view {v} row {y} dropped: {over:.1f}× the bound at its worst bin; "
        + "; ".join(times))
    return out


def anterp_check(tag, args, kw):
    """anterp_taps on one recorded input against the plain version at the
    summation-order bound, repeated bit-equal, and a planted fault (the
    heaviest tap dropped: the weights of the tap with the largest sum
    zeroed) that the bound must see. Returns (max |diff|, the check's
    message, the fault's worst ratio to the bound)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    P, qi0, W = args
    Wt = W.shape[1]
    want = shift.anterp_taps_plain(*args)
    absum = shift.anterp_taps_plain(P.abs(), qi0, W.abs())
    got = shift.anterp_taps(*args, **kw)
    repeat_check("anterp_taps", got, shift.anterp_taps(*args, **kw))
    err, msg = _sum_bound_check(f"anterp_taps ({tag})", got, want, absum, Wt)
    cut = W.clone()
    cut[:, int(W.abs().sum(dim=(0, 2)).argmax())] = 0.0
    short = shift.anterp_taps(P, qi0, cut, **kw)
    torch.cuda.synchronize()
    tol = 2 * Wt * 2.0 ** -24 * absum
    over = float(((short - want).abs() / tol.clamp_min(1e-30)).max())
    if not over > 1.0:
        raise AssertionError(f"anterp_taps' bound does not see a dropped "
                             f"tap ({over})")
    return err, msg, over


def anterp_bound(args) -> dict:
    """anterp_taps' bound: each input and output once, 2 flops a tap."""
    P, qi0, W = args
    V, B, Ntp = P.shape
    Wt, Lp = W.shape[1], W.shape[2]
    return bound_ms(4 * (V * B * Ntp + V * Lp + V * Wt * Lp + V * B * Lp),
                    2 * Wt * V * B * Lp, F32_FLOPS)


def anterp_checks(tag, args, kw, reps) -> dict:
    """anterp_taps on one recorded input as :func:`anterp_check` holds it,
    with the device time and the wrapper's. Returns the call's stats."""
    P, qi0, W = args
    V, B, Ntp = P.shape
    Wt, Lp = W.shape[1], W.shape[2]
    err, msg, over = anterp_check(tag, args, kw)
    st = dict(err=err, **_anterp_stats(args, kw, reps))
    log(f"{tag}: anterp_taps V={V} B={B} Wt={Wt} Lp={Lp} Ntp={Ntp}: {msg}; "
        f"two launches bit-equal; heaviest tap dropped: {over:.1f}× the bound "
        f"at its worst output; {st['ms']:.4f} ms (kernel "
        f"{st['device_ms']:.4f} ms on the device), plain "
        f"{st['plain_ms']:.4f} ms, bound "
        f"{max(st['bytes_ms'], st['ops_ms']):.4f} ms")
    return st


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
    _psnr_two_ways(pj, f32, ref, g)
    return launches


def _psnr_two_ways(pj, f32, ref, g) -> None:
    """The OS-SART convert's PSNR against the phantoms scored both ways
    (a measurement, ROADMAP Queue 3): with peak = max μ over μ, as above,
    and as the engine scores (miu2pixel images, data_range = 1), for this
    phase's convert (10 sweeps of 40 subsets) and for the engine corpus's
    (4 sweeps of 18 subsets) of the same four sinograms."""
    import torch
    from ipdm_tpu_torch.data.units import miu2pixel
    from ipdm_tpu_torch.metrics import psnr
    from ipdm_tpu_torch.recon import sart_fast

    with torch.inference_mode():
        corpus = sart_fast.sart_fast_convert(pj, g, nstart=4, nsubsets=18)
    refs = [r.cpu().numpy().astype(np.float64) for r in ref]
    for label, conv in (("10 sweeps of 40 subsets", f32),
                        ("4 sweeps of 18 subsets (the corpus's)", corpus)):
        imgs = [c.cpu().numpy().astype(np.float64) for c in conv]
        by_mu = [round(psnr(r, c, data_range=float(r.max())), 4)
                 for r, c in zip(refs, imgs)]
        by_px = [round(psnr(miu2pixel(r), miu2pixel(c), data_range=1), 4)
                 for r, c in zip(refs, imgs)]
        log(f"record-FP: OS-SART PSNR against the phantoms, {label} (2 "
            f"full dose, 2 at dose {DOSE}): peak = max μ {by_mu} dB; the "
            f"engine's miu2pixel, data_range=1: {by_px} dB")


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
            st = deposit_checks(tag, args, kw, reps,
                                ("fp_shift_deposit_batched",
                                 "fp_shift_deposit"))
            st8.append(st["fp_shift_deposit_batched"])
            st9.append(st["fp_shift_deposit"])
        row("fp_shift_deposit_batched", "ipdm_tpu_torch/csrc/fp_deposit.cu",
            "ipdm_tpu/ops/pallas/shift.py:354", st8)
        row("fp_shift_deposit", "ipdm_tpu_torch/csrc/fp_deposit.cu",
            "ipdm_tpu/ops/pallas/shift.py:625", st9)

        # anterp_taps in project_fast's form (Wt = 6), outside the row's
        # means (the row is the ART path's)
        for args, kw in fp_calls["anterp_taps"]:
            anterp_checks(tag + " (project_fast)", args, kw, reps)

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
            repeat_check("os_sart_sweep bf16", got,
                         shift.os_sart_sweep(*args, **kw))
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
                f"{over:.1f}× the tolerance at its worst pixel; two "
                f"launches bit-equal; "
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
        args, kw = art_calls["os_sart_sweep"][-1]
        sweep_profile(tag + " (bf16)", lambda: shift.os_sart_sweep(
            *args, **dict(kw, bf16=True)), args[1].shape[0])
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


# the three converts of the unfused phase: label → sart_fast_convert options
UNFUSED_CONVERTS = (("unfused", dict(fused=False)),
                    ("fused_unfolded", dict(fold=False)),
                    ("unfused_unfolded", dict(fused=False, fold=False)))
# the kernels each convert runs (the fused one's deposit and BP run in its
# norms only)
UNFUSED_KERNELS = {"unfused": ("fp_plane_deposit", "bp_shift", "anterp_taps"),
                   "fused_unfolded": ("os_sart_sweep", "anterp_taps"),
                   "unfused_unfolded": ("fp_plane_deposit", "bp_shift",
                                        "anterp_taps")}
UNFUSED_TIMED = 4   # calls timed per (convert, kernel, part)


def bp_check(tag, args, kw):
    """bp_shift_accumulate_batched on one recorded input against the plain
    version: f32 sums over the views in another order, 1e-4 of each output
    plus 1e-5 of the largest; two launches bit-equal. Beside it a planted
    fault the tolerance must see: one view's second taps s1 moved by one
    bin (the view with the largest Σ frac). Returns (max |diff|, the
    fault's worst ratio to the tolerance)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    Q, s0, s1, fr, n = args
    got = shift.bp_shift_accumulate_batched(*args, **kw)
    repeat_check(f"bp_shift ({tag})", got,
                 shift.bp_shift_accumulate_batched(*args, **kw))
    want = shift.bp_shift_accumulate_plain(*args)
    torch.cuda.synchronize()
    atol = 1e-5 * float(want.abs().max())
    ok, err = _within(got, want, 1e-4, atol)
    if not ok:
        raise AssertionError(f"bp_shift ({tag}) disagrees: max |diff| {err} "
                             f"(tol {atol:.3e} + 1e-4·|plain|)")
    v = int(fr.sum(dim=1).argmax())
    moved = s1.clone()
    lo, hi = kw["bounds"]
    moved[v] += 1 if hi + 1 + n <= Q.shape[-1] else -1
    cut = shift.bp_shift_accumulate_batched(
        Q, s0, moved, fr, n, bounds=(min(lo, int(moved[v].min())),
                                     max(hi, int(moved[v].max()))))
    torch.cuda.synchronize()
    over = float(((cut - want).abs() / (atol + 1e-4 * want.abs())).max())
    if not over > 1.0:
        raise AssertionError(f"bp_shift's tolerance does not see view {v}'s "
                             f"s1 moved by one bin ({over})")
    return err, over


def _bp_stats(args, kw, reps) -> dict:
    """bp_shift's times and bound on one recorded call."""
    from ipdm_tpu_torch.ops.cuda import shift

    Q, s0, s1, fr, n = args
    V, B, L = Q.shape
    fn = lambda: shift.bp_shift_accumulate_batched(*args, **kw)
    return dict(**bound_ms(4 * (V * B * L + 3 * V * n + B * n * n),
                           4 * V * B * n * n, F32_FLOPS),
                ms=cuda_ms(fn, reps), device_ms=queued_ms(fn, reps),
                plain_ms=cuda_ms(lambda: shift.bp_shift_accumulate_plain(
                    *args), 3))


def _deposit_stats(args, kw, reps) -> dict:
    from ipdm_tpu_torch.ops.cuda import shift

    fn = lambda: shift.fp_plane_deposit(*args, **kw)
    return dict(**deposit_bound(args, args[0].shape[1]), ms=cuda_ms(fn, reps),
                device_ms=queued_ms(fn, reps),
                plain_ms=cuda_ms(lambda: shift.fp_plane_deposit_plain(*args),
                                 3))


def _anterp_stats(args, kw, reps) -> dict:
    from ipdm_tpu_torch.ops.cuda import shift

    fn = lambda: shift.anterp_taps(*args, **kw)
    return dict(**anterp_bound(args), ms=cuda_ms(fn, reps),
                device_ms=queued_ms(fn, reps),
                plain_ms=cuda_ms(lambda: shift.anterp_taps_plain(*args), 3))


def unfused_kernel_checks(tag, kernel, part, calls, reps) -> dict:
    """Every recorded call of one kernel in one part of a convert against
    its plain version at the kernel's rule, each beside its planted fault
    (:func:`deposit_check`, :func:`bp_check`, :func:`anterp_check`); the
    times and bound of UNFUSED_TIMED of them, spread over the calls.
    Prints one line; returns the shape entry of the kernels JSON line."""
    def check(a, k):
        """(max |diff|, the planted fault's ratio to the tolerance)."""
        if kernel == "bp_shift":
            return bp_check(tag, a, k)
        r = (deposit_check if kernel == "fp_plane_deposit"
             else anterp_check)(tag, a, k)
        return r[0], r[2]

    timing = {"fp_plane_deposit": _deposit_stats, "bp_shift": _bp_stats,
              "anterp_taps": _anterp_stats}[kernel]
    errs, overs = zip(*(check(a, k) for a, k in calls))
    err, control = max(errs), min(overs)
    step = max(1, len(calls) // UNFUSED_TIMED)
    stats = [dict(err=err, **timing(a, k, reps)) for a, k in calls[::step]]
    # (views, images, length) of each call: the deposit's rows [n, B, W]
    # land on [V, B, L]; the BP reads Q [V, B, L]; anterp_taps reads P
    # [V, B, Ntp] into [V, B, Lp]
    if kernel == "fp_plane_deposit":
        dims = [(a[1].shape[0], a[0].shape[1], a[5]) for a, _ in calls]
    elif kernel == "bp_shift":
        dims = [tuple(a[0].shape) for a, _ in calls]
    else:
        dims = [(*a[0].shape[:2], a[2].shape[2]) for a, _ in calls]
    span = lambda i: [min(d[i] for d in dims), max(d[i] for d in dims)]
    shape = dict(V=span(0), B=int(dims[0][1]), L=span(2))
    if kernel == "anterp_taps":
        shape["Wt"] = int(calls[0][0][2].shape[1])
    entry = dict(convert=tag, part=part, **shape_entry(stats, **shape),
                 checked_calls=len(calls), control_min=control)
    log(f"unfused: {tag}: {kernel} ({part}, {shape}): {len(calls)} calls "
        f"within the rule of the plain version, max |diff| {err:.3e}, every "
        f"planted fault at least {control:.1f}× the tolerance; {len(stats)} "
        f"timed: {entry['ms']:.4f} ms per launch (kernel "
        f"{entry['device_ms']:.4f} ms on the device), plain "
        f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms")
    return entry


def _crop_psnr(a, b, c: int) -> float:
    """tests/test_sart_fast.py's PSNR on the images cropped by c: the range
    of ``a`` over the RMS of a − b."""
    a = a[c:-c, c:-c].double()
    b = b[c:-c, c:-c].double()
    rng = max(float(a.max() - a.min()), 1e-9)
    return 10 * math.log10(rng ** 2 / float(((a - b) ** 2).mean()))


def phase_unfused(seed: int, reps: int) -> dict:
    """The unfused OS-SART and the unfolded view set at full width
    (SIEMENS_FBP; 4 random-ellipse phantoms projected by project_fast;
    the Mayo preset's 10 sweeps of 40 subsets): the fused convert the ART
    slice runs, then three converts, each with its plan built anew in the
    run and the launch counters set to 0 just before it and read just
    after: ``fused=False``, ``fold=False`` and ``fused=False,
    fold=False``. Every kernel call of each convert's last sweep, of its
    resample and of its norms against the plain version beside a planted
    fault; two runs of each bit-equal; plan, norms and convert times; the
    images against each other and the phantoms (:func:`_unfused_compare`);
    then the unfused convert at 64², card vs CPU. Returns {"launches":
    {convert: counts}, "shapes": {kernel: [shape entries]}, "times":
    {convert: times}}."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import sart_fast
    from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP
    from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom

    g = SIEMENS_FBP
    n = g.grid_n
    rng = np.random.default_rng(seed)
    vol = torch.as_tensor(np.stack([random_ellipse_phantom(n, rng)
                                    for _ in range(4)]).astype(np.float32),
                          device="cuda")
    kw = dict(nstart=ART_SLICE_OPT["sart_nstart"],
              nsubsets=ART_SLICE_OPT["sart_subsets"])
    with torch.inference_mode():
        pj = sart_fast.project_fast(vol, g, g.N, float(g.nda[0]),
                                    float(g.da))
        imgs = {"fused": sart_fast.sart_fast_convert(pj, g, **kw)}
        ms = {"fused": cuda_ms(lambda: sart_fast.sart_fast_convert(
            pj, g, **kw), 3, warmup=1)}
    launches, shapes, times = {}, {}, {}
    for label, opt in UNFUSED_CONVERTS:
        fused = opt.get("fused", True)
        fold = opt.get("fold", True)
        run = lambda: sart_fast.sart_fast_convert(pj, g, **kw, **opt)
        # the main-path run: plan and norms built in it; the last sweep's
        # calls of the per-subset kernels (at most two branches a subset)
        # and every anterp_taps call recorded
        tail = 2 if fused else 2 * kw["nsubsets"]
        sweep_names = (("os_sart_sweep",) if fused else
                       ("fp_plane_deposit", "bp_shift_accumulate_batched"))
        recs = {nm: Recorder(sart_fast, nm, tail=tail) for nm in sweep_names}
        recs["anterp_taps"] = Recorder(sart_fast, "anterp_taps")
        sart_fast._SPLANS.clear()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode(), contextlib.ExitStack() as stack:
            for r in recs.values():
                stack.enter_context(r)
            img = run()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches[label] = dict(_build.LAUNCHES)
        if tuple(img.shape) != (4, n, n) or not torch.isfinite(img).all():
            raise AssertionError(f"{label} convert output {tuple(img.shape)}")
        imgs[label] = img
        # the plan and its norms built again, timed, their calls recorded
        sart_fast._SPLANS.clear()
        norm_names = ("fp_plane_deposit", "bp_shift_accumulate_batched",
                      "anterp_taps")
        nrecs = {nm: Recorder(sart_fast, nm) for nm in norm_names}
        with torch.inference_mode(), contextlib.ExitStack() as stack:
            for r in nrecs.values():
                stack.enter_context(r)
            t0 = time.perf_counter()
            sp = sart_fast._splan_for(g, kw["nsubsets"], fold=fold,
                                      kf=1 if fused else None)
            t_plan = time.perf_counter() - t0
            sart_fast._norms_for(sp, pj.device, fused)
            torch.cuda.synchronize()
            t_norms = time.perf_counter() - t0 - t_plan
        with torch.inference_mode():
            _build.reset_launches()
            again = run()
            torch.cuda.synchronize()
            warm = dict(_build.LAUNCHES)
            repeat = run()
            torch.cuda.synchronize()
            if not torch.equal(again, repeat) or not torch.equal(again, img):
                raise AssertionError(f"{label}: two runs of the convert "
                                     f"differ")
            ms[label] = cuda_ms(run, 3, warmup=1)
        grps = [grp for pair in sp.groups for grp in pair]
        live = sum(grp.V > 0 for grp in grps)
        times[label] = dict(cold_s=cold, plan_s=t_plan, norms_s=t_norms,
                            ms=ms[label])
        log(f"unfused: {label} convert of 4 sinograms (fused={fused}, "
            f"fold={fold}; plan Kf={sp.Kf}, "
            + (f"{sp.dsub['x'][0]}+{sp.dsub['y'][0]} drive subsets of "
               f"Vp={sp.dsub['x'][1]}" if fused else
               f"{live} subset branches of V "
               f"{min(grp.V for grp in grps)}-{max(grp.V for grp in grps)}, "
               f"L {min(grp.L for grp in grps)}-"
               f"{max(grp.L for grp in grps)}")
            + f"): first run {cold:.3f} s (plan {t_plan:.3f} s, norms "
            f"{t_norms:.3f} s when built alone), warm {ms[label]:.3f} ms; "
            f"launches in the main-path run {launches[label]}, per warm "
            f"convert {warm}; two warm runs bit-equal to the first")
        missing = [k for k in UNFUSED_KERNELS[label]
                   if launches[label][k] <= 0]
        if missing:
            raise AssertionError(f"the {label} convert skipped {missing}")
        # each kernel's recorded calls against its plain version
        with torch.inference_mode():
            an = recs["anterp_taps"].calls
            n_nt = len(nrecs["anterp_taps"].calls)   # nt_full's come first
            parts = [("anterp_taps", "nt_full", an[:n_nt]),
                     ("anterp_taps", "resample", an[n_nt:])]
            if fused:
                # the row-range control where a one-row cut can show
                stats = [sweep_checks(f"unfused: {label}", a, k, reps,
                                      row_control=False)
                         for a, k in recs["os_sart_sweep"].calls]
                S, Vp, B, _ = recs["os_sart_sweep"].calls[-1][0][1].shape
                shapes.setdefault("os_sart_sweep", []).append(dict(
                    convert=label, part="last sweep",
                    **shape_entry(stats, S=S, Vp=Vp, B=B)))
            else:
                for nm, kernel in (("fp_plane_deposit", "fp_plane_deposit"),
                                   ("bp_shift_accumulate_batched",
                                    "bp_shift")):
                    calls = list(recs[nm].calls)[-live:]
                    parts.append((kernel, "last sweep", calls))
            parts += [("fp_plane_deposit", "norms",
                       nrecs["fp_plane_deposit"].calls),
                      ("bp_shift", "norms",
                       nrecs["bp_shift_accumulate_batched"].calls)]
            for kernel, part, calls in parts:
                shapes.setdefault(kernel, []).append(unfused_kernel_checks(
                    label, kernel, part, list(calls), reps))
    log(f"unfused: warm ms per convert of 4 sinograms {ms}")
    _unfused_compare(imgs, vol, pj, g)
    _small_unfused_check(seed)
    return dict(launches=launches, shapes=shapes, times=times)


def _unfused_compare(imgs, vol, pj, g) -> None:
    """The converts against each other and against the phantoms (4
    random-ellipse phantoms; crop n/16 pixels a side; PSNR over the range
    of the first image, as tests/test_sart_fast.py scores), at the Mayo
    settings (10 sweeps of 40 subsets) and at that test's own (8 and 4
    sweeps of 18 subsets). Gated: the unfused sweep's folded vs unfolded
    PSNR above 30 dB (that test's floor) at 8 and at 4 sweeps of 18
    subsets, where the two view sets' subsets differ (the plan takes the
    largest count at most 18 that divides its views: 10 subsets of the
    1000 folded views, 16 of the 2000 unfolded ones); at 10 sweeps of 40
    subsets every unfolded subset holds both views φ and φ + π of each
    folded view, so the two updates are the same sums and that reading
    is an identity, gated above 90 dB (f32 rounding only). Printed beside the floor the
    JAX package's test sets at 64² (25 dB and scale Σ(f·u)/Σu² within 5%
    for unfused vs fused, 30 dB for the fused sweep's folded vs unfolded):
    the fused sweep drifts from the phantom after a few sweeps (the JAX
    package's does too: tests/test_torch_sart_unfolded.py holds the port
    to it where it does), so these say how far the two sweeps' images lie
    apart, not whether the port is right; beside them each sweep's PSNR
    against the phantoms at 2, 4 and 10 sweeps."""
    import torch
    from ipdm_tpu_torch.recon import sart_fast

    n = g.grid_n
    c = n // 16
    ref = vol.transpose(1, 2)                          # recon orientation

    def psnrs(xs, ys):
        return [round(_crop_psnr(x, y, c), 3) for x, y in zip(xs, ys)]

    def scales(old, new):
        return [round(float((y[c:-c, c:-c].double() * x[c:-c, c:-c]).sum()
                            / (x[c:-c, c:-c].double() ** 2).sum()), 4)
                for x, y in zip(old, new)]

    def verdict(ps, floor, sc=None):
        ok = min(ps) > floor and (sc is None or
                                  max(abs(v - 1.0) for v in sc) < 0.05)
        return "meets" if ok else "misses"

    conv = lambda ns, nsub, **o: sart_fast.sart_fast_convert(
        pj, g, nstart=ns, nsubsets=nsub, **o)
    with torch.inference_mode():
        runs = {(10, 40): imgs}
        for ns, nsub in ((8, 18), (4, 18)):
            runs[ns, nsub] = {
                "fused": conv(ns, nsub),
                "unfused": conv(ns, nsub, fused=False),
                "fused_unfolded": conv(ns, nsub, fold=False),
                "unfused_unfolded": conv(ns, nsub, fused=False, fold=False)}
        track = {ns: (conv(ns, 40), conv(ns, 40, fused=False))
                 for ns in (2, 4)}
    fold_gate = {}
    for (ns, nsub), r in runs.items():
        ps, sc = psnrs(r["unfused"], r["fused"]), scales(r["unfused"],
                                                         r["fused"])
        pf = psnrs(r["fused_unfolded"], r["fused"])
        pu = psnrs(r["unfused_unfolded"], r["unfused"])
        floor = 90.0 if (ns, nsub) == (10, 40) else 30.0
        fold_gate[ns, nsub] = (pu, floor)
        log(f"unfused: {ns} sweeps of {nsub} subsets, PSNR (dB): unfused "
            f"vs fused {ps}, scale {sc} ({verdict(ps, 25.0, sc)} JAX's 25 "
            f"dB / 5% floor); fused folded vs unfolded {pf} "
            f"({verdict(pf, 30.0)} its 30 dB floor); unfused folded vs "
            f"unfolded {pu} (gated > {floor:.0f} dB"
            + (", an identity here)" if floor > 30.0 else ")"))
    track[10] = (imgs["fused"], imgs["unfused"])
    log("unfused: PSNR against the phantoms (dB), fused / unfused sweep, "
        "40 subsets: " + "; ".join(
            f"{ns} sweeps {psnrs(ref, f)} / {psnrs(ref, u)}"
            for ns, (f, u) in sorted(track.items())))
    for (ns, nsub), (pu, floor) in fold_gate.items():
        if min(pu) <= floor:
            raise AssertionError(f"the unfused convert's folded and "
                                 f"unfolded images differ at {ns} sweeps of "
                                 f"{nsub} subsets: PSNR {pu} dB (floor "
                                 f"{floor} dB)")


def _small_unfused_check(seed: int) -> None:
    """The unfused convert at 64² (180 views of 128 detectors, 10 sweeps of
    18 subsets) on the card against the CPU, on a Shepp-Logan phantom
    projected by project_fast: within 1e-3 of the CPU image's max, as
    phase_reference_art holds the fused convert, and its PSNR against the
    phantom. Then the same on a uniform random sinogram, printed only:
    there the rays that graze the grid's corners carry huge ratios, where
    sums in another order can move the corner pixels."""
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
    kw = dict(nstart=10, nsubsets=18, fused=False)
    before = dict(_build.LAUNCHES)
    with torch.inference_mode():
        fan = sart_fast.project_fast(torch.from_numpy(ph[None]), g, geom.nr,
                                     float(g.nda[0]), float(g.da))
        noise = torch.from_numpy(np.random.default_rng(seed).random(
            (1, 180, 128)).astype(np.float32))
        res = {}
        for name, x in (("phantom", fan), ("random", noise)):
            cpu = sart_fast.sart_fast_convert(x, g, **kw)[0]
            gpu = sart_fast.sart_fast_convert(x.cuda(), g, **kw)[0].cpu()
            d = (cpu - gpu).abs()
            res[name] = (float(d.max()), float(cpu.abs().max()),
                         int((d > 1e-3 * cpu.abs().max()).sum()), gpu)
    used = {k: _build.LAUNCHES[k] - before[k] for k in before}
    err, top, _, gpu = res["phantom"]
    ref = torch.from_numpy(ph.T.copy())
    psnr = 10 * math.log10(float(ref.max()) ** 2
                           / float(((gpu - ref) ** 2).mean()))
    r_err, r_top, r_over, _ = res["random"]
    log(f"unfused: 64² sart_fast_convert(fused=False), 10 sweeps of 18 "
        f"subsets, of a projected Shepp-Logan phantom: card vs CPU max "
        f"|diff| {err:.3e} (tol 1e-3·max|cpu| = {1e-3 * top:.3e}); PSNR "
        f"against the phantom {psnr:.2f} dB; of a uniform random sinogram "
        f"(printed only): max |diff| {r_err:.3e} at max|cpu| {r_top:.3e}, "
        f"{r_over} of 4096 pixels past 1e-3·max|cpu|; card launches {used}")
    if not (torch.isfinite(gpu).all() and err <= 1e-3 * top):
        raise AssertionError(f"64² unfused convert: card and CPU differ by "
                             f"{err}")
    if used["fp_plane_deposit"] <= 0 or used["bp_shift"] <= 0:
        raise AssertionError(f"64² unfused convert skipped kernels: {used}")


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


def phase_engine(seed: int, out: str):
    """The example's steps at full width from files on disk under
    ``out``: corpus, checkpoints, ``ProgressiveDomainDenoiser(...).fit()``
    in test_prog mode. Returns the launches of that run, those of the FBP
    slice that follows through update_opt, bp_shift_accumulate's calls in
    it, and the corpus's os_sart_sweep calls (one image each)."""
    import torch
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.recon import fbp_fast, sart_fast

    ex = _example()
    names = ["psnr", "ssim", "fsim", "vif", "nqm"]
    n_slices = 2
    sart_fast._SPLANS.clear()     # a user's first run builds the plans
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    with Recorder(sart_fast, "os_sart_sweep") as corpus:
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
    return launches, fbp_one, bp1.calls, corpus.calls


def phase_kernels_corpus(calls, reps, sweep_row):
    """os_sart_sweep on the engine corpus's own sweeps (B = 1, the last
    sweep of each drive of the last slice, where x ≠ 0) against its plain
    version at the f32 sweep's tolerance, with the repeat check; timed
    into the sweep row's shapes."""
    import torch
    from ipdm_tpu_torch.ops.cuda import shift

    stats = []
    with torch.inference_mode():
        for args, kw in calls[-2:]:
            x, rf, inv2, frac, s0, nrmi, lam = args
            if not float(x.abs().max()) > 0:
                raise AssertionError("os_sart_sweep (corpus) held on x = 0")
            want = shift.os_sart_sweep_plain(*args)
            got = shift.os_sart_sweep(*args, **kw)
            repeat_check("os_sart_sweep (corpus)", got,
                         shift.os_sart_sweep(*args, **kw))
            over = sweep_over(got, want)
            err = float((got - want).abs().max())
            S, Vp, B, L = rf.shape
            n = x.shape[-1]
            live = int((inv2 != 0).any(dim=2).sum())
            s = dict(err=err, **bound_ms(
                4 * (2 * B * n * n + S * Vp * B * L + S * Vp * L
                     + 2 * S * Vp * n + S * n * n),
                8 * live * B * n * n + 2 * S * Vp * B * L + 4 * S * B * n * n,
                F32_FLOPS),
                ms=cuda_ms(lambda: shift.os_sart_sweep(*args, **kw), reps),
                plain_ms=cuda_ms(lambda: shift.os_sart_sweep_plain(*args),
                                 2, 1))
            log(f"kernels-corpus: os_sart_sweep S={S} Vp={Vp} ({live} live "
                f"views) B={B} n={n} L={L} lam={lam:.4f}: max |diff| "
                f"{err:.3e}, {over:.3f}× the tolerance (1e-5·max|plain| + "
                f"1e-4·|plain|); two launches bit-equal; {s['ms']:.4f} ms, "
                f"plain {s['plain_ms']:.4f} ms, bound "
                f"{max(s['bytes_ms'], s['ops_ms']):.4f} ms")
            if not over <= 1.0:
                raise AssertionError(f"os_sart_sweep (corpus) disagrees: "
                                     f"{over}× the tolerance")
            stats.append(s)
    sweep_row["shapes"].append(shape_entry(stats, S=S, Vp=Vp, B=B))


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
            got = shift.bp_shift_accumulate(*args, **kw)
            repeat_check("bp_shift_accumulate", got,
                         shift.bp_shift_accumulate(*args, **kw))
            want = shift.bp_shift_accumulate_plain(Q, s0, s1, fr, n)[0]
            batched = shift.bp_shift_accumulate_batched(Q, s0, s1, fr, n,
                                                        **kw)[0]
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
                ms=cuda_ms(lambda: shift.bp_shift_accumulate(*args, **kw),
                           reps),
                device_ms=queued_ms(lambda: shift.bp_shift_accumulate(
                    *args, **kw), reps),
                plain_ms=cuda_ms(lambda: shift.bp_shift_accumulate_plain(
                    Q, s0, s1, fr, n), 5))
            log(f"{tag}: bp_shift_accumulate V={V} L={L} n={n}: max |diff| "
                f"{err:.3e} (tol {atol:.2e} + 1e-4·|plain|), from the "
                f"batched kernel {same:.1e}; two launches bit-equal; "
                f"{s['ms']:.4f} ms (kernel {s['device_ms']:.4f} ms on the "
                f"device), plain "
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


TRAIN_STEPS = 10   # per train run: 2 slices × 5 epochs at batch 1
TRAIN_SAVE_FREQ = 5
# kernels each train run's main path must launch; planar_unit only in the
# proj UNet (the img UNet has no planar level)
TRAIN_KERNELS = {"img": ("flash_attn_f32", "flash_bwd_dq", "flash_bwd_dkv"),
                 "proj": ("flash_attn_f32", "flash_bwd_dq", "flash_bwd_dkv",
                          "planar_unit")}


def _train_preset(domain: str) -> dict:
    """Config/Mayo-Config/train_{domain}_option.json as a dict."""
    path = osp.join(osp.dirname(osp.abspath(__file__)), "Config",
                    "Mayo-Config", f"train_{domain}_option.json")
    with open(path) as f:
        return json.load(f)


def _train_run(domain: str, out: str, seed: int, paths: dict,
               overrides=None, max_iter=None):
    """``ProgressiveDomainDenoiser(...).fit()`` in train_{domain} mode on
    the engine phase's corpus at the preset's widths and dtype (or with
    the options ``overrides``, and cut to ``max_iter`` steps), with each
    train() call timed and its launches and peak memory read; returns
    (engine, per-step records, the run's launches, s of fit())."""
    import torch
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
    from ipdm_tpu_torch.ops.cuda import _build

    opt = IPDMConfig().merge(_train_preset(domain))
    opt.merge(dict(device="cuda", seed=seed, display_result=False,
                   max_epochs=TRAIN_STEPS // 2, save_freq=TRAIN_SAVE_FREQ,
                   test_numbers=1, metrics=["psnr", "ssim"],
                   run_name=f"chip_smoke_train_{domain}", **paths))
    opt.merge(overrides or {})
    eng = ProgressiveDomainDenoiser(opt, result_save_path=out)
    if max_iter is not None:
        eng.opt.max_iter = max_iter
    steps = []
    train = eng.train

    def timed(inputs, n_iter, loss_temp):
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = train(inputs, n_iter, loss_temp)   # reads the loss back
        torch.cuda.synchronize()
        steps.append(dict(
            s=time.perf_counter() - t0, loss=loss,
            peak=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={k: _build.LAUNCHES[k] - before[k] for k in before
                      if _build.LAUNCHES[k] - before[k]}))
        return loss

    eng.train = timed
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.fit()
    torch.cuda.synchronize()
    return eng, steps, dict(_build.LAUNCHES), time.perf_counter() - t0


def phase_train(seed: int, out: str):
    """train_img, then train_proj, through the engine at the shipped train
    presets' widths and dtype (f32; img mc 64, channel_mult (1, 1, 2, 2,
    4, 4), attention at 8 / 16, B = 1, 512²; proj 2000×912, 12 planar
    units and 5 flash blocks per eval), on the engine phase's corpus (its
    full-dose images and sinograms; both slices are the test set too),
    10 steps each, checkpoints and test(it) every 5 steps with one test
    slice, PSNR / SSIM only; the PNG grids (display_result, which
    train_proj's preset sets) are the figures phase's. Each step's loss, warm
    s/step, peak memory of a step, the kernels' launches per step, the
    checkpoint files and the scalars.jsonl lines; then a resume from
    optimizer-1, whose Adam state must equal the file's. Returns the
    recorded inputs of the f32 flash forward and backward (the first
    calls of each run: T = 4096, then 7125) and each run's launches."""
    import torch

    ex = _example()
    paths = ex.dataset_paths(out)
    fwd_calls, bwd_calls, runs = [], [], {}
    log("train: display_result=False (the PNG grids are the figures "
        "phase's; they need matplotlib); metrics psnr, ssim")
    # as main_torch.py trains: PyTorch's default precision (convolutions
    # through cuDNN in TF32, matmuls in f32), which the kernel checks above
    # turned off
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _train_runs(seed, out, paths, fwd_calls, bwd_calls, runs)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _train_runs(seed, out, paths, fwd_calls, bwd_calls, runs):
    """:func:`phase_train`'s two runs and their checks."""
    import torch
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
    from ipdm_tpu_torch.ops.cuda import attention

    for domain in ("img", "proj"):
        with Recorder(attention, "_forward", limit=1) as fwd, \
                Recorder(attention, "flash_bwd_dq", limit=1) as bwd:
            eng, steps, launches, t_fit = _train_run(domain, out, seed,
                                                     paths)
        fwd_calls += fwd.calls
        bwd_calls += bwd.calls
        runs[domain] = launches
        losses = [st["loss"] for st in steps]
        warm = [st["s"] for st in steps[1:]]
        per_step = steps[-1]["launches"]
        models = eng.logger.models_save_dir
        files = sorted(os.listdir(models))
        with open(osp.join(eng.save_root, "trainSummary",
                           "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        log(f"train: {domain}, {eng.opt.compute_dtype}, "
            f"{len(steps)} steps: losses "
            + ", ".join(f"{x:.5f}" for x in losses))
        log(f"train: {domain}: warm {sum(warm) / len(warm):.4f} s/step "
            f"(steps 2-{len(steps)}, host clock ended by "
            f"torch.cuda.synchronize(); first step {steps[0]['s']:.4f} s); "
            f"peak memory of a step {max(st['peak'] for st in steps):.2f} "
            f"GiB; launches per step {per_step}; fit() {t_fit:.3f} s "
            f"(with 2 × test(it) of one slice); launches in the run "
            f"{ {k: v for k, v in launches.items() if v} }")
        log(f"train: {domain}: checkpoints {files}; scalars.jsonl "
            f"{len(scalars)} lines, tags "
            f"{sorted({d['tag'] for d in scalars})}")
        want_files = {f"{domain}_model-{i}" for i in (1, 2)} | {
            f"optimizer-{i}" for i in (1, 2)}
        missing = [k for k in TRAIN_KERNELS[domain] if per_step.get(k, 0)
                   <= 0]
        if (len(steps) != TRAIN_STEPS
                or not all(math.isfinite(x) for x in losses)
                or not want_files <= set(files) or missing
                or not any(d["tag"] == "train/loss" for d in scalars)):
            raise AssertionError(f"train {domain}: {len(steps)} steps, "
                                 f"losses {losses}, files {files}, "
                                 f"kernels not launched in a step "
                                 f"{missing}")
        mode = "deImg" if domain == "img" else "deProj2img"
        for it in (1, 2):
            with open(osp.join(eng.save_root_path, f"Save_Iter_{it}",
                               "metric.json")) as f:
                m = json.load(f)
            vals = [v for k, v in m[mode].items() if k.startswith("psnr")
                    and not k.endswith("_std")]
            log(f"train: {domain}: test({it}) on the trained weights: "
                f"{mode} PSNR {[round(v, 4) for v in vals]} dB, LDCT "
                f"{m['LDCT']['psnr_iter_0']:.4f} dB")
            if not vals or not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"train {domain}: test({it}) scored "
                                     f"{vals}")
        if domain == "img":
            # resume from optimizer-1: Adam's state equal to the file's
            cfg = dict(eng.opt.to_dict(), resume_epochs_img=1,
                       load_img_model_path=models,
                       run_name="chip_smoke_resume")
            eng2 = ProgressiveDomainDenoiser(IPDMConfig(**cfg),
                                             result_save_path=out)
            saved = torch.load(osp.join(models, "optimizer-1"),
                               weights_only=True)["state"]
            got = eng2.optimizer.state_dict()["state"]
            same = got.keys() == saved.keys() and all(
                torch.equal(got[i][k].cpu(), v[k]) for i, v in saved.items()
                for k in ("step", "exp_avg", "exp_avg_sq"))
            step = int(saved[0]["step"])
            log(f"train: img: resume from optimizer-1: Adam's moments and "
                f"step equal to the file's: {same}; step {step}; resume_iter "
                f"{eng2.opt.resume_iter}")
            if not same or step <= 0:
                raise AssertionError(f"resume: state equal {same}, step "
                                     f"{step}")
            del eng2
        del eng
    return fwd_calls, bwd_calls, runs


def _bwd_stats(dtype_name, q, k, v, out, lse, do, scale, reps):
    """flash_bwd_dq and flash_bwd_dkv on one recorded input (the forward
    kernel's out and lse, as the main path hands them) against
    attention_bwd_plain: per tensor |kernel − plain| over its tolerance
    (bf16: 2e-2·max|plain| + 2e-2·|plain|; f32: 1e-4·max|plain| +
    1e-3·|plain|), two launches bit-equal, the planted D-dropped dK. The
    recorded out and lse are held to the plain forward's (out at the
    forward's rule, :func:`flash_tol`; lse by :func:`lse_check`, with the
    forward run again: its lse bit-equal to the recorded one). In f32 the
    plain backward runs on the plain forward's out and lse; in bf16 on
    the kernel's, the backward's own inputs: the two bf16 forwards round
    out at different points (normalised P or not), and D = rowsum(dO∘O)
    carries that into dq, whose Σ_j dS_ij = 0 cancels (from the plain
    forward's out and lse, dq misses the rule at T = 4096 on an H100).
    Also the times of the kernels, the plain backward, the
    recomputed backward and SDPA forward + backward."""
    import torch
    import torch.nn.functional as F
    from ipdm_tpu_torch.ops.cuda import attention

    _, lse2 = attention._forward(q, k, v, scale, with_lse=True)
    repeat_check("flash forward lse", lse, lse2)
    lse_over, lse_ctrl = lse_check(lse, q, k, scale, dtype_name)
    pout, plse = attention.attention_lse_plain(q, k, v, scale)
    rtol, atol = flash_tol(pout, dtype_name)
    ok, out_err = _within(out, pout, rtol, atol)
    if not ok:
        raise AssertionError(f"flash forward out at T={q.shape[1]} "
                             f"{dtype_name}: max |diff| {out_err}")
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale)
    dq2, D2 = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk2, dv2 = attention.flash_bwd_dkv(q, k, v, lse, do, D2, scale)
    for name, a, b in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        repeat_check(f"flash_bwd {name}", a, b)
    fwd = (out, lse) if dtype_name == "bfloat16" else (pout, plse)
    want = attention.attention_bwd_plain(q, k, v, *fwd, do, scale)
    del pout, plse
    rel, share = BWD_TOL[dtype_name]
    over = dict(lse=lse_over)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        tol = share * float(w.float().abs().max()) + rel * w.float().abs()
        over[name] = float(((g.float() - w.float()).abs() / tol).max())
    ctrl_dk, _ = attention.flash_bwd_dkv(q, k, v, lse, do,
                                         torch.zeros_like(D), scale)
    tol = share * float(want[1].float().abs().max()) + rel * want[1].float(
        ).abs()
    ctrl = float(((ctrl_dk.float() - want[1].float()).abs() / tol).max())
    torch.cuda.synchronize()
    err = {n: float((g.float() - w.float()).abs().max())
           for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    BH, T, hd = q.shape
    slow = max(2, reps // 4)
    q4, k4, v4 = (t_.detach().view(1, BH, T, hd).requires_grad_()
                  for t_ in (q, k, v))
    do4 = do.view(1, BH, T, hd)

    def sdpa():
        with torch.enable_grad():
            o4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                scale=scale * scale)
            torch.autograd.grad(o4, (q4, k4, v4), do4)

    def recompute():
        with torch.enable_grad():
            leaves = [t_.detach().requires_grad_() for t_ in (q, k, v)]
            o = attention.attention_plain(*leaves, scale)
            torch.autograd.grad(o, leaves, do)

    t = dict(dq_ms=cuda_ms(lambda: attention.flash_bwd_dq(
                 q, k, v, out, lse, do, scale), reps),
             dkv_ms=cuda_ms(lambda: attention.flash_bwd_dkv(
                 q, k, v, lse, do, D, scale), reps),
             plain_ms=cuda_ms(lambda: attention.attention_bwd_plain(
                 q, k, v, out, lse, do, scale), slow),
             recompute_ms=cuda_ms(recompute, slow),
             library_ms=cuda_ms(sdpa, reps))
    err["out"] = out_err
    return over, err, dict(dk=ctrl, lse=lse_ctrl), t


# the forward's lse against the plain one: |Δ| ≤ ε·R + T·2⁻²³ per row,
# ε per activation dtype (see lse_check)
LSE_EPS = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -16}


def lse_check(lse, q, k, scale, dtype_name):
    """The forward kernel's lse against attention_lse_plain's, per row
    |Δ| ≤ ε·R_i + T·2⁻²³, with R_i = Σ_j P_ij Σ_d |q_id·s|·|k_jd·s| the
    softmax-weighted size of the scores, which bounds (to first order) how
    far rounding the scores by a relative ε moves the lse. The plain
    version rounds q·s and k·s to the activation dtype and the kernel
    applies s² to the f32 score: 2⁻⁸ apart in bf16, each f32 sum of 64
    products adds up to 64·2⁻²⁴; ε is twice their sum (:data:`LSE_EPS`).
    T·2⁻²³: twice the worst rounding of the f32 sum of T exponentials.
    Returns (the largest |Δ| over its bound, the same for a planted
    control, the kernel's lse in log2 units), raising if the lse misses
    its bound or the control meets it."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    s = attention._scores(q, k, scale)
    plse = torch.logsumexp(s, -1)
    p = torch.softmax(s, -1)
    del s
    acc = attention._acc
    R = (acc(q * scale).abs()
         * torch.matmul(p, acc(k * scale).abs())).sum(-1)
    del p
    tol = LSE_EPS[dtype_name] * R + q.shape[1] * 2.0 ** -23
    over = float(((lse - plse).abs() / tol).max())
    ctrl = float(((lse * math.log2(math.e) - plse).abs() / tol).max())
    if over > 1.0 or ctrl <= 1.0:
        raise AssertionError(f"flash forward lse [{tuple(q.shape)}] "
                             f"{dtype_name}: {over} of its bound, the "
                             f"log2-units control at {ctrl}")
    return over, ctrl


# flash backward tolerance per dtype, (rtol, atol as a share of the
# tensor's max|plain|): bf16 as the forward's rule scaled to each
# tensor's largest entry; f32 the grad phase's rule
BWD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-3, 1e-4)}
# csrc/flash_bwd.cu's body per dtype and its bf16 tensor-core passes per
# product: f32 operands split into hi + lo, hi·hi + hi·lo + lo·hi
BWD_BODY = {"bfloat16": "wgmma bf16", "float32": "wgmma, 3 bf16 passes"}
BWD_PASSES = {"bfloat16": 1, "float32": 3}


def bwd_ragged(reps, counts=(4097, 7125), hd=64, tag="kernels-train"):
    """The backward kernels at T = 4097 (the last 64-row tile holds one
    live row: a wrong mask or zero-fill shows there first) and T = 7125
    on the forward's ragged inputs
    (q ≈ +1, k ≈ −1: live scores ≈ −8, so a key past T that escaped a
    mask, score 0, would dominate), in both dtypes, with the forward
    kernel's out and lse (its lse held to :func:`lse_check`), at the main
    path's rule (:data:`BWD_TOL`): bf16 against the plain backward on the
    same inputs, as in :func:`_bwd_stats`. In f32 these inputs make dq a
    cancellation (Σ_j dS_ij = 0 exactly, and with k_j ≈ −1 the terms'
    common part cancels), so the f32 reference is the plain forward and
    backward in f64 on the same q, k, v, dO, and the f32 plain forward
    and backward is held to it beside the kernels as a second witness
    (rule: :data:`RAGGED_F32_EPS`). Planted controls that must
    fail the same check: the plain forward and backward on K and V
    zero-padded to whole 64-key tiles (the kernels with the last key tile
    unmasked), and the dK kernel with D dropped from dS. At a head dim hd
    below 64, q and k are scaled by a = (64 / hd)^¼ (live scores ≈ −8).
    Returns one dict per (T, dtype): the largest of dq/dk/dv over its
    tolerance and max |diff|, the two kernels' ms, SDPA forward +
    backward's ms (None where it does not run) and the bounds."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    a = (64 / hd) ** 0.25
    stats = []
    for T, dtype_name in itertools.product(counts, ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)

        def rnd(mean, sd, amp=1.0):
            return (amp * (mean + sd * torch.randn(
                (4, T, hd), generator=gen, device="cuda"))).to(dtype)
        q, k, do = rnd(1.0, 0.25, a), rnd(-1.0, 0.25, a), rnd(0.0, 1.0)
        v = rnd(torch.arange(1.0, 5.0, device="cuda").view(4, 1, 1), 0.5)
        out, lse = attention._forward(q, k, v, scale, with_lse=True)
        lse_over, lse_ctrl = lse_check(lse, q, k, scale, dtype_name)
        dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
        dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale)
        ctrl_dk, _ = attention.flash_bwd_dkv(q, k, v, lse, do,
                                             torch.zeros_like(D), scale)
        if dtype_name == "float32":
            ins = [t_.double() for t_ in (q, k, v, do)]
            out64, lse64 = attention.attention_lse_plain(*ins[:3], scale)
            want = attention.attention_bwd_plain(*ins[:3], out64, lse64,
                                                 ins[3], scale)
            sizes = _bwd_sizes(*ins, out64, lse64, scale)
            del out64, lse64
            plain = attention.attention_bwd_plain(
                q, k, v, *attention.attention_lse_plain(q, k, v, scale), do,
                scale)
            ref = "the f64 plain forward and backward"
        else:  # on the kernel's out and lse, as in _bwd_stats
            want = attention.attention_bwd_plain(q, k, v, out, lse, do,
                                                 scale)
            ref = "the bf16 plain backward on the kernel's out and lse"
        pad = torch.zeros((4, -T % 64, hd), dtype=dtype, device="cuda")
        kp, vp = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
        # what the kernels compute without the mask: the forward's lse
        # and out over the dead keys too, then the backward over them
        got_p = [g[:, :T] for g in attention.attention_bwd_plain(
            q, kp, vp, *attention.attention_lse_plain(q, kp, vp, scale),
            do, scale)]
        want = [w.to(torch.promote_types(w.dtype, torch.float32))
                for w in want]
        rel, share = BWD_TOL[dtype_name]
        rules = [share * float(w.abs().max()) + rel * w.abs() for w in want]
        tols = rules
        rule = f"{share:g}·max|ref| + {rel:g}·|ref|"
        if dtype_name == "float32":
            tols = [r + RAGGED_F32_EPS * z for r, z in zip(rules, sizes)]
            rule += " + 2⁻²⁰·Σ|terms before the cancellation|"
        torch.cuda.synchronize()

        def over(got, i, tol=tols):
            return float(((got.to(want[i].dtype) - want[i]).abs()
                          / tol[i]).max())

        res = [over(g, i) for i, g in enumerate((dq, dk, dv))]
        ctrl = max(over(g, i) for i, g in enumerate(got_p))
        ctrl_d = over(ctrl_dk, 1)
        err = [float((g.to(w.dtype) - w).abs().max())
               for g, w in zip((dq, dk, dv), want)]
        witness, ctrl_r = "", math.inf
        if dtype_name == "float32":
            wit = [over(g, i) for i, g in enumerate(plain)]
            alone = [over(g, i, rules) for grads in ((dq, dk, dv), plain)
                     for i, g in enumerate(grads)]
            ctrl_r = max(over(g, i) for i, g in enumerate(
                _bwd_rounded_ds(q, k, v, do, scale)))
            witness = (f"; the f32 plain backward at {wit[0]:.3f} / "
                       f"{wit[1]:.3f} / {wit[2]:.3f} of the same tolerance; "
                       f"against the relative rule alone the kernels at "
                       f"{alone[0]:.3f} / {alone[1]:.3f} / {alone[2]:.3f}, "
                       f"the f32 plain at {alone[3]:.3f} / {alone[4]:.3f} / "
                       f"{alone[5]:.3f}; planted control, the f32 plain "
                       f"with dS rounded to bf16: {ctrl_r:.2f}×")
        times = dict(
            dq_ms=cuda_ms(lambda: attention.flash_bwd_dq(
                q, k, v, out, lse, do, scale), reps),
            dkv_ms=cuda_ms(lambda: attention.flash_bwd_dkv(
                q, k, v, lse, do, D, scale), reps),
            library_ms=sdpa_ms(q, k, v, scale, reps, do=do))
        stats.append(dict(
            T=T, hd=hd, dtype=dtype_name, over=max(res), err=max(err),
            **times, dq_bound_ms=flash_bound(4, T, hd, dtype_name, "dq"),
            dkv_bound_ms=flash_bound(4, T, hd, dtype_name, "dkv")))
        log(f"{tag}: flash_bwd ragged [4,{T},{hd}] "
            f"{SHORT[dtype_name]} (live scores ≈ −8, {-T % 64} dead keys; "
            f"reference {ref}, tolerance {rule}): "
            f"dq/dk/dv at {res[0]:.3f} / {res[1]:.3f} / {res[2]:.3f} of the "
            f"tolerance (max |diff| {err[0]:.3e} / {err[1]:.3e} / "
            f"{err[2]:.3e}){witness}; the forward's lse at {lse_over:.4f} "
            f"of its bound, in log2 units {lse_ctrl:.1f}×; planted "
            f"controls: the last key tile unmasked {ctrl:.1f}×, D dropped "
            f"from dS {ctrl_d:.1f}× the tolerance; dq {times['dq_ms']:.4f} "
            f"ms (bound {stats[-1]['dq_bound_ms']:.4f}), dkv "
            f"{times['dkv_ms']:.4f} ms (bound "
            f"{stats[-1]['dkv_bound_ms']:.4f}), SDPA forward + backward "
            + ("not run" if times["library_ms"] is None else
               f"{times['library_ms']:.4f} ms"))
        if max(res) > 1.0:
            raise AssertionError(f"flash backward disagrees at ragged T: "
                                 f"{res}")
        if ctrl <= 1.0 or ctrl_d <= 1.0 or ctrl_r <= 1.0:
            raise AssertionError(f"a ragged control passes: unmasked "
                                 f"{ctrl}, D dropped {ctrl_d}, dS in bf16 "
                                 f"{ctrl_r}")
    return stats


# the f32 ragged backward's allowance for rounding before the
# cancellation, per unit of Σ|terms| (:func:`_bwd_sizes`): each term's P
# comes from exp of a difference of ~16 in magnitude (|S| + |lse|, 16·2⁻²⁴
# relative), and the row-shared lse and D make the terms' errors add in a
# line rather than as a random walk
RAGGED_F32_EPS = 2.0 ** -20


def _bwd_sizes(q, k, v, do, out, lse, scale):
    """Per entry of dq, dk and dv, Σ|terms| of the sum that makes it with
    each dS term taken before its cancellations, P·(|dO|·|v|ᵀ + Σ|O||dO|)
    (dP and D as sums of absolute values): dq over the keys of that
    times |k·s|·s, dk over the queries with |q·s|, dv over the queries of
    P·|dO|. In q's dtype (f64 for the witness)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    qs, ks, dof = (attention._acc(t_) for t_ in (q * scale, k * scale, do))
    p = torch.exp(torch.matmul(qs, ks.transpose(1, 2)) - lse[..., None])
    dv = torch.matmul(p.transpose(1, 2), dof.abs())
    pre = p * (torch.matmul(dof.abs(), attention._acc(v).abs().transpose(
        1, 2)) + (attention._acc(out) * dof).abs().sum(-1)[..., None])
    del p
    return (torch.matmul(pre, ks.abs()) * scale,
            torch.matmul(pre.transpose(1, 2), qs.abs()) * scale, dv)


def _bwd_rounded_ds(q, k, v, do, scale):
    """A planted fault: the plain f32 forward and backward with dS rounded
    to bf16 before the products that make dq and dk."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    out, lse = attention.attention_lse_plain(q, k, v, scale)
    qs, ks, dof, p, ds = attention._probs_ds(
        q, k, v, lse, do, attention._rowsum(out, do), scale)
    ds = ds.to(torch.bfloat16).float()
    return (torch.matmul(ds, ks) * scale,
            torch.matmul(ds.transpose(1, 2), qs) * scale,
            torch.matmul(p.transpose(1, 2), dof))


def bwd_call_stats(tag, dtype_name, args, reps):
    """flash_bwd_dq and flash_bwd_dkv on one recorded backward input
    (args: q, k, v, out, lse, do, scale) by :func:`_bwd_stats`, logged
    with the bound of the body that ran; raises where a tensor misses its
    tolerance or the D-dropped control meets it. Returns the stats of the
    dq and of the dkv kernel (one entry each of a row's ``shapes``)."""
    q, k, v, out, lse, do, scale = args
    over, err, ctrl, t = _bwd_stats(dtype_name, q, k, v, out,
                                    lse, do, scale, reps)
    BH, T, hd = q.shape
    es = q.element_size()
    # the body that ran: bf16 products on wgmma; f32 as three
    # bf16 passes on wgmma, beside the CUDA-core count of the
    # same f32 products
    passes = BWD_PASSES[dtype_name]
    pair = 10 * BH * T * T * hd
    nbytes = BH * T * hd * es * 6 + 8 * BH * T
    b_dq = bound_ms(nbytes, passes * 6 * BH * T * T * hd,
                    BF16_FLOPS)
    b_dkv = bound_ms(nbytes, passes * 8 * BH * T * T * hd,
                     BF16_FLOPS)
    cores = dict(
        dq=6 * BH * T * T * hd / F32_FLOPS * 1e3,
        dkv=8 * BH * T * T * hd / F32_FLOPS * 1e3)
    body = BWD_BODY[dtype_name]
    also = ("" if dtype_name == "bfloat16" else
            f"; {pair / F32_FLOPS * 1e3:.4f} ms at the f32 "
            f"CUDA-core rate")
    src = ("the kernel's" if dtype_name == "bfloat16" else
           "the plain forward's")
    log(f"{tag}: flash_bwd [{BH},{T},{hd}] "
        f"{SHORT[dtype_name]} (recorded on the main path; "
        f"reference from {src} out and lse): "
        f"dq/dk/dv at {over['dq']:.3f} / {over['dk']:.3f} / "
        f"{over['dv']:.3f} of the tolerance (max |diff| "
        f"{err['dq']:.3e} / {err['dk']:.3e} / {err['dv']:.3e}); "
        f"the forward's out max |diff| {err['out']:.3e} (the "
        f"forward's rule), its lse at {over['lse']:.4f} of its "
        f"bound "
        f"(ε = 2^{math.log2(LSE_EPS[dtype_name]):.0f}), "
        f"planted control in log2 units {ctrl['lse']:.1f}×; "
        f"two launches bit-equal; planted control, D dropped "
        f"from dS: dk at {ctrl['dk']:.1f}× the tolerance; dq "
        f"{t['dq_ms']:.4f} ms + dkv {t['dkv_ms']:.4f} ms = "
        f"{t['dq_ms'] + t['dkv_ms']:.4f} ms on {body} (bound "
        f"of the pair, {passes}×10·T²·{hd}·BH operations at the "
        f"bf16 tensor-core rate: "
        f"{passes * pair / BF16_FLOPS * 1e3:.4f} ms{also}); "
        f"plain backward {t['plain_ms']:.4f} ms; the recomputed "
        f"backward {t['recompute_ms']:.4f} ms; SDPA forward + "
        f"backward {t['library_ms']:.4f} ms (the pair at "
        f"{(t['dq_ms'] + t['dkv_ms']) / t['library_ms']:.3f}× "
        f"it)")
    if max(over.values()) > 1.0 or ctrl["dk"] <= 1.0:
        raise AssertionError(f"flash backward at T={T} "
                             f"{dtype_name}: {over}, D-dropped "
                             f"control {ctrl}")
    common = dict(plain_ms=t["plain_ms"],
                  library_ms=t["library_ms"],
                  recompute_ms=t["recompute_ms"], T=T,
                  dtype=dtype_name, body=body)
    return (dict(common, err=err["dq"], ms=t["dq_ms"],
                 cuda_core_bound_ms=cores["dq"], **b_dq),
            dict(common, err=max(err["dk"], err["dv"]), ms=t["dkv_ms"],
                 cuda_core_bound_ms=cores["dkv"], **b_dkv))


def phase_kernels_train(fwd_calls, bwd_calls, grad_calls, runs, reps):
    """The f32 flash forward on the train runs' recorded q, k, v (T = 4096
    and 7125) by :func:`flash_f32_check`, with its ragged checks and
    planted control; the backward kernels on the recorded backward inputs
    (f32 from the train runs, bf16 from the grad phase) against
    attention_bwd_plain, bit-equal over two launches, each beside a
    planted D-dropped control; the ragged backward checks. Returns the
    rows of the kernels JSON line (flash_bwd_dq, flash_bwd_dkv) with each
    run's launches, and the forward's stats."""
    import torch

    rows = []
    # no_grad, not inference_mode: the timed yardsticks run autograd
    with torch.no_grad():
        fwd_stats = flash_f32_check("kernels-train", fwd_calls, reps)
        flash_ragged(reps, "float32", (4097, 7125))

        # the backward kernels: f32 from the train runs, bf16 from grad
        per = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
        for dtype_name, calls in (("float32", bwd_calls),
                                  ("bfloat16", grad_calls)):
            for args, kw in calls:
                dq, dkv = bwd_call_stats("kernels-train", dtype_name, args,
                                         reps)
                per["flash_bwd_dq"].append(dq)
                per["flash_bwd_dkv"].append(dkv)
        for name, st in per.items():
            summarise(rows, "kernels-train", name,
                      "ipdm_tpu_torch/csrc/flash_bwd.cu",
                      "ipdm_tpu/models/unet.py:601 → jax/experimental/"
                      "pallas/ops/tpu/flash_attention.py:"
                      + ("1287" if name.endswith("dq") else "941"),
                      st, True)
            rows[-1]["library"] = ("SDPA forward + backward of the same "
                                   "q, k, v, dO (both kernels' work)")
            rows[-1]["shapes"] = [dict(
                T=x["T"], dtype=x["dtype"], body=x["body"], ms=x["ms"],
                plain_ms=x["plain_ms"], recompute_ms=x["recompute_ms"],
                library_ms=x["library_ms"],
                bound_ms=max(x["bytes_ms"], x["ops_ms"]),
                cuda_core_bound_ms=x["cuda_core_bound_ms"],
                max_abs_err=x["err"]) for x in st]
        bwd_ragged(reps)
    for row in rows:
        name = row["name"]
        row["launches"] = runs["img"][name] + runs["proj"][name]
        row["launches_train_img"] = runs["img"][name]
        row["launches_train_proj"] = runs["proj"][name]
    return rows, fwd_stats


# ---------------------------------------------------------------------------
# The exact physics, sparse (DDIM) sampling and the PNG result grids
# ---------------------------------------------------------------------------

# the ART slice with the reference's own reconstructor: the footprint
# OS-SART (recon/sart.py) in place of the fast one
EXACT_ART_OPT = dict(ART_SLICE_OPT, exact_art=True)
# the shipped test preset, read from the checkout
PRESET_PATH = osp.join("Config", "Mayo-Config", "test_progressive_option.json")
# kernels the sparse slice's main path launches once the OS-SART plan is
# built: the UNets' (f32, the preset's dtype), the sweep and the resample
DDIM_KERNELS = ("planar_unit", "flash_attn_f32", "os_sart_sweep",
                "anterp_taps")
# the exact phase's views for the adjointness check (degrees)
ADJOINT_VIEWS = (0.0, 33.3, 137.0, 271.0)


def shipped_preset() -> dict:
    """Config/Mayo-Config/test_progressive_option.json as a dict."""
    with open(osp.join(osp.dirname(osp.abspath(__file__)), PRESET_PATH)) as f:
        return json.load(f)


def ddim_slice_opt() -> dict:
    """The shipped test preset with sparse (DDIM) sampling in both
    domains, at its own dtype (it sets none: the config's f32)."""
    return dict(shipped_preset(), sample_method_proj="sparse",
                sample_method_img="sparse", compute_dtype="float32")


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev) -> float:
    import torch
    if torch.device(dev).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _timed(fn, dev):
    """fn()'s result and its host time in ms, synchronised at both ends."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _psnr(img, ref) -> float:
    """PSNR of img against ref with the peak max|ref|."""
    mse = float(((img.double() - ref.double()) ** 2).mean())
    return 10 * math.log10(float(ref.abs().max()) ** 2 / mse)


def _fp_scatter(foot, x, geom, how: str):
    """The FP's scatter of one block of views (recon/projector.py
    fp_one_angle's values and bin indices) through ``index_add_`` or
    ``index_put_(accumulate=True)``: the two scatter-adds PyTorch offers,
    for the repeat measurement."""
    import torch
    V, P = foot.div.shape
    vals = (x[None] / foot.div)[..., None] * foot.areas
    offs = torch.arange(geom.nfoot, device=x.device)
    idx = foot.s_bin[..., None] + offs
    vals = torch.where((idx >= 0) & (idx < geom.nr), vals,
                       torch.zeros((), device=x.device)).reshape(-1)
    idx = (idx.clamp(0, geom.nr - 1) + geom.nr * torch.arange(
        V, device=x.device)[:, None, None]).reshape(-1)
    out = torch.zeros(V * geom.nr, device=x.device)
    if how == "index_add_":
        return out.index_add_(0, idx, vals)
    return out.index_put_((idx,), vals, accumulate=True)


def exact_repeats(foot, x, geom, reps: int) -> None:
    """Whether the FP's scatter-add gives the same bits twice: index_add_
    and index_put_(accumulate=True), each with and without
    torch.use_deterministic_algorithms, on one block of views at full
    width; the max |diff| between two runs and the ms of one."""
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    try:
        for det in (False, True):
            torch.use_deterministic_algorithms(det)
            for how in ("index_add_", "index_put_"):
                try:
                    a = _fp_scatter(foot, x, geom, how)
                    b = _fp_scatter(foot, x, geom, how)
                except RuntimeError as e:
                    log(f"exact: FP scatter {how} deterministic={det}: "
                        f"refused ({str(e)[:120]})")
                    continue
                torch.cuda.synchronize()
                diff = float((a - b).abs().max())
                ms = cuda_ms(lambda: _fp_scatter(foot, x, geom, how), reps)
                log(f"exact: FP scatter of {foot.div.shape[0]} views through "
                    f"{how}, deterministic algorithms {det}: two runs "
                    f"{'bit-equal' if torch.equal(a, b) else 'differ'} (max "
                    f"|diff| {diff:.3e} of max {float(a.abs().max()):.4f}), "
                    f"{ms:.4f} ms")
    finally:
        torch.use_deterministic_algorithms(was)


def small_exact_check(seed: int, dev: str = "cuda") -> None:
    """forward_project, fbp_convert and recons (nstart 10, 40 subsets) of a
    64² phantom on ``dev`` against the CPU, each within 1e-3 of the CPU
    result's range."""
    import torch
    from ipdm_tpu_torch.recon import projector
    from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan, recons
    from ipdm_tpu_torch.recon.fbp import fbp_convert
    from ipdm_tpu_torch.recon.geometry import area_lut, default_betas
    from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom

    geom = _example().make_geom(64)
    vol = torch.as_tensor(random_ellipse_phantom(
        64, np.random.default_rng(seed))[None], dtype=torch.float32)
    lut, betas = area_lut(geom), default_betas(geom)
    out = {}
    for d in ("cpu", dev):
        sino = projector.forward_project_batch(vol.to(d), geom, lut, betas)
        fbp = fbp_convert(sino, fbp_geom_from_fan(geom))
        art = recons(sino, geom, nstart=10, nsubsets=40)
        _sync(d)
        out[d] = [t.cpu() for t in (sino, fbp, art)]
    for name, got, want in zip(("forward_project", "fbp_convert", "recons"),
                               out[dev], out["cpu"]):
        rng_ = float(want.max() - want.min())
        err = float((got - want).abs().max())
        log(f"exact: 64² {name} {tuple(want.shape)} on the card against the "
            f"CPU: max |diff| {err:.3e} = {err / rng_:.2e} of the range "
            f"{rng_:.4f} (tol 1e-3)")
        if not err <= 1e-3 * rng_:
            raise AssertionError(f"exact {name}: card and CPU differ by "
                                 f"{err} (range {rng_})")
    art = out["cpu"][2][0]
    log(f"exact: 64² recons PSNR against the phantom: transposed "
        f"{_psnr(art, vol[0].T):.2f} dB, as is {_psnr(art, vol[0]):.2f} dB")


def phase_exact(models, seed: int, reps: int, dev: str = "cuda",
                size: int = 512) -> dict:
    """The reference's own reconstructor in plain PyTorch on the card, at
    the SIEMENS geometry (``size`` 512; a smaller one rehearses it): the
    projector pair's adjointness on a few views with a planted control;
    the exact FP of a phantom (ms; the scatter-add's repeat behaviour);
    fbp_convert and recons (the preset's nstart 10, 40 subsets) of that
    one sinogram (ms, peak memory, finite, recons ≥ 0, PSNR against the
    phantom, two recons runs' max |diff|); the 64² card-vs-CPU check;
    then one ART slice with ``exact_art`` (bf16 UNets, the exact convert
    of the four kept iterations): s/slice and its stage split. Returns
    the numbers for the record."""
    import torch
    from ipdm_tpu_torch.engine.denoiser import (make_convertor,
                                                progressive_denoiser)
    from ipdm_tpu_torch.recon import projector
    from ipdm_tpu_torch.recon.convertor import Convertor, recons
    from ipdm_tpu_torch.recon.fbp import fbp_convert
    from ipdm_tpu_torch.recon.geometry import area_lut, default_betas
    from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom

    geom = _example().make_geom(size)
    fbp_geom = Convertor("FBP", geom=geom).fbp_geom
    lut = torch.as_tensor(area_lut(geom), device=dev)
    betas = torch.as_tensor(default_betas(geom), device=dev)
    xy = torch.as_tensor(projector.pixel_centers(geom),
                         device=dev).reshape(-1, 2)
    host = np.random.default_rng(seed)
    P = geom.nx * geom.ny
    rec = {}
    with torch.inference_mode():
        # the pair's adjointness: ⟨FP x, y⟩ = (1/dr)·⟨x, BP y⟩, rtol 1e-4;
        # a BP with one footprint bin dropped has to miss it
        x = torch.as_tensor(host.random(P, np.float32), device=dev)
        y = torch.as_tensor(host.random(geom.nr, np.float32), device=dev)
        worst, planted = 0.0, float("inf")
        for ang in ADJOINT_VIEWS:
            foot = projector.footprint_for_angle(
                geom, lut, xy, torch.tensor(ang, device=dev))
            lhs = float(torch.dot(projector.fp_one_angle(x, foot, geom)
                                  .double(), y.double()))

            def rhs(f):
                return float(torch.dot(x.double(), projector.bp_one_angle(
                    y, f, geom).double())) / geom.dr

            worst = max(worst, abs(lhs - rhs(foot)) / abs(lhs))
            areas = foot.areas.clone()
            areas[:, 2] = 0
            planted = min(planted, abs(lhs - rhs(foot._replace(
                areas=areas))) / abs(lhs))
        log(f"exact: adjointness ⟨FP x, y⟩ = (1/dr)·⟨x, BP y⟩ at "
            f"{list(ADJOINT_VIEWS)}°: worst relative gap {worst:.2e} (rtol "
            f"1e-4); with the BP's middle footprint bin dropped "
            f"{planted:.2e} at the least")
        if not (worst <= 1e-4 and planted > 1e-4):
            raise AssertionError(f"exact adjointness {worst}, planted "
                                 f"{planted}")

        # the exact FP of a phantom: the sinogram the converts below read
        vol = torch.as_tensor(random_ellipse_phantom(geom.nx, host),
                              dtype=torch.float32, device=dev)
        _peak_reset(dev)
        sino, fp_ms = _timed(lambda: projector.forward_project(
            vol, geom, lut, betas), dev)
        again = projector.forward_project(vol, geom, lut, betas)
        _sync(dev)
        rec.update(fp_ms=fp_ms, fp_repeat=float((sino - again).abs().max()))
        log(f"exact: forward_project of a {geom.nx}² phantom → "
            f"{tuple(sino.shape)} in {fp_ms:.1f} ms (views in blocks of "
            f"{projector.VIEW_BLOCK}), peak {_peak_gib(dev):.2f} GiB; a "
            f"second run {'bit-equal' if torch.equal(sino, again) else 'differs'}"
            f" (max |diff| {rec['fp_repeat']:.3e} of max "
            f"{float(sino.abs().max()):.4f})")
        if torch.device(dev).type == "cuda":
            foot = projector.footprint_for_angle(geom, lut, xy,
                                                 betas[:projector.VIEW_BLOCK])
            exact_repeats(foot, vol.reshape(-1), geom, reps)

        _peak_reset(dev)
        fbp, fbp_ms = _timed(lambda: fbp_convert(sino[None], fbp_geom), dev)
        fbp_peak = _peak_gib(dev)
        _peak_reset(dev)
        art, art_ms = _timed(lambda: recons(sino[None], geom, nstart=10,
                                            nsubsets=40), dev)
        art_peak = _peak_gib(dev)
        art2, art2_ms = _timed(lambda: recons(sino[None], geom, nstart=10,
                                              nsubsets=40), dev)
        rec.update(fbp_ms=fbp_ms, fbp_peak=fbp_peak, art_ms=art_ms,
                   art_ms_second=art2_ms, art_peak=art_peak,
                   art_repeat=float((art - art2).abs().max()))
        ref = vol.T
        for name, img, ms, peak in (("fbp_convert", fbp, fbp_ms, fbp_peak),
                                    ("recons", art, art_ms, art_peak)):
            finite = bool(torch.isfinite(img).all())
            log(f"exact: {name} of one {tuple(sino.shape)} sinogram → "
                f"{tuple(img.shape)}: {ms:.1f} ms, peak {peak:.2f} GiB, "
                f"finite={finite}, min {float(img.min()):.4f}, PSNR against "
                f"the phantom (peak max μ) transposed "
                f"{_psnr(img[0], ref):.2f} dB, as is {_psnr(img[0], vol):.2f}"
                f" dB")
            if not finite or tuple(img.shape) != (1, geom.nx, geom.ny):
                raise AssertionError(f"exact {name}: {tuple(img.shape)} "
                                     f"finite={finite}")
            if not _psnr(img[0], ref) > _psnr(img[0], vol):
                raise AssertionError(f"exact {name}: not in the recons "
                                     f"(transposed) orientation")
        if not float(art.min()) >= 0.0:
            raise AssertionError(f"exact recons below 0: {float(art.min())}")
        log(f"exact: recons again {art2_ms:.1f} ms; the two runs "
            f"{'bit-equal' if torch.equal(art, art2) else 'differ'} (max "
            f"|diff| {rec['art_repeat']:.3e} of max {float(art.max()):.4f})")
        del sino, again, fbp, art, art2

    small_exact_check(seed, dev)

    if models is None:
        return rec
    # one ART slice with the exact convert (the four kept iterations in
    # one batched footprint OS-SART)
    proj_model, img_model = models
    opt = dict(EXACT_ART_OPT, geometry=_example().geometry_overrides(size))
    ld = torch.as_tensor(host.random((1, geom.na, geom.nr, 1), np.float32)
                         * 4.0, device=dev)
    timer = StageTimer(make_convertor(opt))
    _peak_reset(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    out = progressive_denoiser(opt, proj_model, img_model, ld, gen,
                               convertor=timer, sharpen_num=SHARPEN,
                               device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    c0, c1 = timer.marks
    finite = bool(torch.isfinite(out).all())
    rec.update(slice_s=dt, proj_s=c0 - t0, convert_s=c1 - c0,
               img_s=t0 + dt - c1, slice_peak=_peak_gib(dev))
    log(f"exact: ART slice with exact_art (105 UNet evals, the footprint "
        f"OS-SART of 4 sinograms): {dt:.3f} s/slice: proj stage "
        f"{rec['proj_s']:.3f} s, convert {rec['convert_s']:.3f} s, img stage "
        f"{rec['img_s']:.3f} s; peak {rec['slice_peak']:.2f} GiB; output "
        f"{tuple(out.shape)} finite={finite}")
    if tuple(out.shape) != (1, geom.nx, geom.ny, 1) or not finite:
        raise AssertionError(f"exact_art slice output {tuple(out.shape)} "
                             f"finite={finite}")
    return rec


class CountedModel:
    """A UNet as the samplers call it, counting its evals."""

    def __init__(self, model):
        self.model = model
        self.evals = 0

    def __call__(self, x, t):
        self.evals += 1
        return self.model(x, t)


def phase_slice_ddim(ld_proj, seed: int, reps: int, sweep_b4: dict) -> dict:
    """The shipped test preset at full width with sparse (DDIM) sampling in
    both domains (:func:`ddim_slice_opt`; f32 UNets built from it, cuDNN
    in TF32 as main_torch.py runs): UNet evals per slice (counted), the
    main-path run, warm slices and their split, the profiled slice
    (:func:`phase_slice`); then one more slice with the kernel wrappers'
    inputs recorded, and on them planar_unit (f32), the f32 flash forward
    (:func:`flash_f32_check`), the sweep at B = 3 (the three kept
    iterations; beside B = 4's time per image from kernels-ART) and
    anterp_taps, each against its plain version. Returns the main-path
    run's launches."""
    import torch
    from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import planar, shift
    from ipdm_tpu_torch.recon import sart_fast

    opt = ddim_slice_opt()
    n_evals = (sum(opt["ddim_timesteps_proj"]) + sum(opt["ddim_timesteps_img"])
               + 15)   # + the ultra pass, 3×5 steps
    torch.manual_seed(seed)
    models = [CountedModel(build_unet(opt, d, device="cuda").eval())
              for d in ("proj", "img")]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        run, warm, _ = phase_slice("DDIM", opt, models, ld_proj, seed,
                                   DDIM_KERNELS, n_evals, n_timed=2)
        evals = [m.evals for m in models]
        per = sum(evals) / 5   # warm-up, main path, 2 timed, profiled
        log(f"slice-DDIM: UNet evals per slice {per:g} (proj "
            f"{evals[0] / 5:g}, img {evals[1] / 5:g}; dense ART: 105); "
            f"DDIM steps proj {opt['ddim_timesteps_proj']} from t "
            f"{opt['t_start_proj']}, img {opt['ddim_timesteps_img']} from t "
            f"{opt['t_start_img']}, then the ultra pass")
        if per != n_evals:
            raise AssertionError(f"DDIM slice: {per} UNet evals per slice, "
                                 f"expected {n_evals}")
        by_shape = lambda a: (tuple(a[0].shape), tuple(a[3].shape))
        recs = [Recorder(unet, "planar_unit", key=by_shape),
                Recorder(unet, "flash_attention",
                         key=lambda a: tuple(a[0].shape)),
                Recorder(sart_fast, "os_sart_sweep"),
                Recorder(sart_fast, "anterp_taps")]
        with contextlib.ExitStack() as stack:
            for r in recs:
                stack.enter_context(r)
            gen = torch.Generator(device="cuda").manual_seed(seed + 20)
            progressive_denoiser(opt, *models, ld_proj, gen)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    pu, fa, sw, an = (r.calls for r in recs)
    del models
    # the plain versions in f32 (convolutions and matmuls without TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        for args, kw in pu:
            x, a, bb, w, bias, skip = args
            act = kw.get("act", True)
            got = planar.planar_unit(x, a, bb, w, bias, skip, act=act)
            want = planar.planar_unit_plain(x, a, bb, w, bias, skip, act=act)
            torch.cuda.synchronize()
            ok, err = _within(got, want, 1e-4, 1e-4)
            log(f"kernels-DDIM: planar_unit f32 C={x.shape[1]} "
                f"O={w.shape[3]} {x.shape[2]}x{x.shape[3]}: max |diff| "
                f"{err:.3e} (tol 1e-4 + 1e-4·|plain|)")
            if not ok:
                raise AssertionError(f"planar_unit (DDIM) disagrees: {err}")
        flash_f32_check("kernels-DDIM", fa, reps)
        # the sweep on the last sweep of each drive (x != 0), B = 3
        for args, kw in sw[-2:]:
            x, rf, inv2, frac, s0, nrmi, lam = args
            B = x.shape[0]
            if not float(x.abs().max()) > 0 or B != 3:
                raise AssertionError(f"os_sart_sweep (DDIM) held at B={B}, "
                                     f"max|x| {float(x.abs().max())}")
            want = shift.os_sart_sweep_plain(*args)
            got = shift.os_sart_sweep(*args, **kw)
            repeat_check("os_sart_sweep (DDIM)", got,
                         shift.os_sart_sweep(*args, **kw))
            over = sweep_over(got, want)
            ms = cuda_ms(lambda: shift.os_sart_sweep(*args, **kw), reps)
            log(f"kernels-DDIM: os_sart_sweep S={rf.shape[0]} B={B}: max "
                f"|diff| {float((got - want).abs().max()):.3e}, {over:.3f}× "
                f"the tolerance (1e-5·max|plain| + 1e-4·|plain|); two "
                f"launches bit-equal; {ms:.4f} ms a call, {ms / B:.4f} ms "
                f"per image (B = 4 in kernels-ART: {sweep_b4['ms']:.4f} ms, "
                f"{sweep_b4['ms'] / 4:.4f} per image)")
            if not over <= 1.0:
                raise AssertionError(f"os_sart_sweep (DDIM) disagrees: "
                                     f"{over}× the tolerance")
        for args, kw in an[-2:]:
            anterp_checks("kernels-DDIM", args, kw, reps)
    return run


def phase_figures(seed: int, out: str, dev: str = "cuda", size: int = 512):
    """``display_result`` on the engine phase's corpus and checkpoints
    under ``out``: ``fit()`` in test_prog mode (the ART settings, one
    slice) draws progressive.png; the PSNR / SSIM strings drawn on its
    axes (captured from ``Axes.text``) must be the slice's metric.json
    values, rounded as the grid rounds them. Without matplotlib the phase
    says that it did not run, and why. Returns whether it ran."""
    import torch
    try:
        import matplotlib.axes
    except ImportError as e:
        log(f"figures: NOT RUN: matplotlib cannot be imported on this "
            f"machine ({e}); display_result needs it, and the engine "
            f"refuses display_result without it")
        return False
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser

    ex = _example()
    ckpt_dir = osp.join(out, "seeded_models")
    cfg = dict(ART_SLICE_OPT, mode="test_prog", run_name="chip_smoke_figures",
               device=dev, seed=seed, metrics=["psnr", "ssim"],
               test_numbers=1, display_result=True, save_it_state_proj=True,
               save_it_state_img=False, geometry=ex.geometry_overrides(size),
               resume_epochs_img=1, resume_epochs_proj=1,
               load_img_model_path=ckpt_dir, load_proj_model_path=ckpt_dir,
               **ex.dataset_paths(out))
    eng = ProgressiveDomainDenoiser(IPDMConfig(**cfg), result_save_path=out)
    texts = []
    text = matplotlib.axes.Axes.text

    def capture(ax, *a, **kw):
        texts.append(kw.get("s"))
        return text(ax, *a, **kw)

    matplotlib.axes.Axes.text = capture
    try:
        t0 = time.perf_counter()
        eng.fit()
        _sync(dev)
        dt = time.perf_counter() - t0
    finally:
        matplotlib.axes.Axes.text = text
    root = osp.join(eng.save_root_path, "Save_Iter_0", "P001")
    (slice_dir,) = [osp.join(root, d) for d in os.listdir(root)]
    png = osp.join(slice_dir, "progressive.png")
    with open(osp.join(slice_dir, "metric.json")) as f:
        m = json.load(f)
    fmt = "PSNR={:.2f} , SSIM={:.2f}".format
    n_proj = sum(k.startswith("psnr_iter_") for k in m["deProj"])
    n_img = sum(k.startswith("psnr_iter_") for k in m["deProg"])
    want = ([fmt(m["LDCT"]["psnr_iter_0"], m["LDCT"]["ssim_iter_0"])]
            + [fmt(m["deProj"][f"psnr_iter_{i}"], m["deProj"][f"ssim_iter_{i}"])
               for i in range(1, n_proj + 1)]
            + [fmt(m["deProg"][f"psnr_iter_{i}"], m["deProg"][f"ssim_iter_{i}"])
               for i in range(n_img, 0, -1)])
    size_b = osp.getsize(png) if osp.exists(png) else 0
    log(f"figures: fit() with display_result, one slice, {dt:.3f} s; "
        f"{osp.basename(png)} {size_b} bytes; {len(texts)} annotations, "
        f"{texts[:2]}...; equal to metric.json's values: {texts == want}")
    if not size_b > 1000 or texts != want:
        raise AssertionError(f"figures: PNG {size_b} bytes; drawn {texts}, "
                             f"metric.json {want}")
    return True


MESH_RANKS = 2
MESH_TIMEOUT = 300   # s for the 2-rank spawn: start-up, train, evals, FBP, FP
MESH_TOL = 1e-4      # sharded vs unsharded f32: max|diff| / max|unsharded|
MESH_WARM_STEPS = 2  # train steps timed after the two checked ones
# the kernels each rank's banded evals must launch: planar_unit runs in
# the proj UNet's banded levels, the f32 flash forward in the gathered ones
MESH_EVAL_KERNELS = {"img": ("flash_attn_f32",),
                     "proj": ("planar_unit", "flash_attn_f32")}
MESH_TRAIN_KERNELS = ("flash_attn_f32", "flash_bwd_dq", "flash_bwd_dkv")


def _mesh_geoms(size: int):
    """(FBP geometry, fan-beam geometry, proj UNet input rows × cols) of
    the mesh phase: the SIEMENS scanner at 512, the example's small
    scanner otherwise (a CPU rehearsal)."""
    from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
    from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP
    from ipdm_tpu_torch.recon.geometry import SIEMENS
    if size == 512:
        return SIEMENS_FBP, SIEMENS, (2000, 912)
    fan = _example().make_geom(size)
    return fbp_geom_from_fan(fan), fan, (fan.na, fan.nr)


def _mesh_checks(rank, tmp, seed, dev_name, size):
    """One rank of the mesh phase, in a process that
    ``parallel/spawn.py`` ``run_ranks`` spawned into a gloo group (see
    :func:`phase_mesh`)."""
    import torch
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # f32 products and convolutions in f32: the sharded and unsharded
        # runs are held to each other
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(2)
    return _mesh_work(rank, seed, dev, size)


def _mesh_planar_check(calls, rank, rows, banded):
    """Each planar_unit call that this rank's banded eval made, against
    the plain version on the same inputs at the f32 rule (1e-4 +
    1e-4·|plain|, as in kernels:); on each call made on a halo'd band (its
    height a banded level's band plus the halo rows) a planted control:
    the plain version on the band with the neighbour's halo row dropped
    (zero padding at the band's edge, what a missing exchange leaves),
    which must fail the same rule on the rows the eval keeps."""
    from ipdm_tpu_torch.ops.cuda import planar
    top, bottom = int(rank > 0), int(rank < MESH_RANKS - 1)
    heights = {(rows >> lvl) + top + bottom for lvl in range(banded)}
    worst, ctrl, seen = 0.0, float("inf"), []
    for args, kw in calls:
        x, a, bb, w, bias, skip = args
        act = kw.get("act", True)
        got = planar.planar_unit(x, a, bb, w, bias, skip, act=act)
        want = planar.planar_unit_plain(x, a, bb, w, bias, skip, act=act)
        ok, err = _within(got, want, 1e-4, 1e-4)
        C, H, W, O = x.shape[1], x.shape[2], x.shape[3], w.shape[3]
        if not ok:
            raise AssertionError(f"mesh: rank {rank}: planar_unit on a "
                                 f"band disagrees at C={C} O={O} {H}x{W}: "
                                 f"max |diff| {err}")
        worst = max(worst, err)
        if H not in heights:
            continue
        seen.append(H)
        cut = slice(top, H - bottom)
        dropped = planar.planar_unit_plain(
            x[:, :, cut].contiguous(), a, bb, w, bias,
            None if skip is None else skip[:, :, cut].contiguous(), act=act)
        c_ok, c_err = _within(dropped, want[:, :, cut], 1e-4, 1e-4)
        if c_ok:
            raise AssertionError(f"mesh: rank {rank}: the control without "
                                 f"its halo row passes at C={C} O={O} "
                                 f"{H}x{W}: the check cannot see it")
        ctrl = min(ctrl, c_err)
    return dict(calls=len(calls), banded_calls=len(seen),
                heights=sorted(set(seen)), max_abs_err=worst,
                control_min_err=ctrl)


def _mesh_work(rank, seed, dev, size):
    import torch
    import torch.distributed as dist
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import diffusion_for
    from ipdm_tpu_torch.engine.trainer import make_optimizer, make_train_step
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.parallel import mesh as M
    from ipdm_tpu_torch.recon.fbp import fbp_convert
    from ipdm_tpu_torch.recon.geometry import area_lut, default_betas
    from ipdm_tpu_torch.recon.phantom import shepp_logan
    from ipdm_tpu_torch.recon.projector import forward_project

    if dev.type == "cuda":
        _build.library()   # built by the parent: loaded here
    dp = M.make_mesh([MESH_RANKS, 1], device_type=dev.type)
    vw = M.make_mesh([1, MESH_RANKS], device_type=dev.type)
    out = {"rank": rank, "device": str(dev)}

    def timed(fn, reps=1):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn()
        _sync(dev)
        return r, (time.perf_counter() - t0) * 1e3 / reps

    def rel(got, want) -> float:
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max())

    def launches():
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    # 1. the img train preset's data-parallel step: global batch 2, one
    # image a rank; the unsharded step on rank 0 from the same init
    opt = IPDMConfig().merge(_train_preset("img"))
    pt = opt.partial_timesteps_img
    gd = diffusion_for(opt, "img", dev)

    def fresh():
        torch.manual_seed(seed)
        return build_unet(opt, "img", device=dev, remat=True)

    images = np.random.default_rng(seed).random((MESH_RANKS, size, size, 1),
                                                np.float32)
    model = fresh()
    step = M.make_sharded_train_step(
        model, gd, make_optimizer(model.parameters(), opt.init_lr), pt, dp,
        torch.Generator(device=dev).manual_seed(seed))
    _build.reset_launches()
    losses, ms = [], []
    for i in range(2):
        loss, t = timed(lambda: float(step(images)))
        losses.append(loss)
        ms.append(t)
        if i == 0:
            grads = [p.grad.detach().clone() for p in model.parameters()]
    out["train"] = dict(losses=losses, ms=ms, launches=launches())
    # two more steps, timed once the shapes' set-up is done
    out["train"]["warm_ms"] = [timed(lambda: float(step(images)))[1]
                               for _ in range(MESH_WARM_STEPS)]
    psum = torch.tensor([float(sum(p.detach().double().sum()
                                   for p in model.parameters()))],
                        dtype=torch.float64, device=dev)
    out["train"]["param_sums"] = [float(v) for v in
                                  M._all_gather(psum, dist.group.WORLD)]
    if rank == 0:
        def ref_run(batch):
            """make_train_step on ``batch`` from the same init: each
            step's (loss, ms), and the first step's gradients."""
            ref = fresh()
            ref_step = make_train_step(
                ref, gd, make_optimizer(ref.parameters(), opt.init_lr), pt,
                torch.Generator(device=dev).manual_seed(seed))
            runs = [timed(lambda: float(ref_step(batch)))]
            g1 = [p.grad.detach().clone() for p in ref.parameters()]
            runs += [timed(lambda: float(ref_step(batch)))
                     for _ in range(1 + MESH_WARM_STEPS)]
            return [r_[0] for r_ in runs], [r_[1] for r_ in runs], g1

        # one process on the global batch: steps 1-2 checked, 3-4 warm
        ref_losses, ref_ms, g1 = ref_run(images)
        gmax = max(float(g.abs().max()) for g in g1)
        gdiff = max(float((g - h).abs().max()) for g, h in zip(grads, g1))
        out["train"].update(ref_losses=ref_losses[:2], ref_ms=ref_ms,
                            grad_rel=gdiff / gmax)
        del g1
        # one process on one rank's share (B = 1): what each rank's DDP
        # step computes, alone on the card
        out["train"]["ref_b1_ms"] = ref_run(images[:1])[1]
    del model, step, grads
    dist.barrier()

    # 2. H-sharded evals at full width, f32 (unsharded on rank 0 first)
    eval_opt = dict(SLICE_OPT, compute_dtype="float32")
    torch.manual_seed(seed)
    models = {"proj": build_unet(eval_opt, "proj", device=dev).eval(),
              "img": build_unet(eval_opt, "img", device=dev).eval()}
    rng = np.random.default_rng(seed + 1)
    shapes = {"img": (size, size), "proj": _mesh_geoms(size)[2]}
    out["evals"] = {}
    for name in ("img", "proj"):
        m = models[name]
        x = torch.as_tensor(rng.standard_normal((1, 1) + shapes[name]),
                            dtype=torch.float32, device=dev)
        t = torch.tensor([10], device=dev)
        apply = M.make_spatial_sharded_apply(m, dp)
        r = out["evals"][name] = {"shape": list(x.shape)}
        with torch.no_grad():
            if rank == 0:
                m(x, t)
                want, r["ms_unsharded"] = timed(lambda: m(x, t), 3)
            dist.barrier()
            _build.reset_launches()
            reduce, calls = dist.all_reduce, []

            def counted(*a, **kw):   # the eval's collectives, each an
                calls.append(1)      # all_reduce (mesh.py's gathers too)
                return reduce(*a, **kw)

            dist.all_reduce = counted
            try:
                with Recorder(unet, "planar_unit") as pu:
                    y = M.gather_rows(apply(M.shard_rows(x, dp), t), dp)
            finally:
                dist.all_reduce = reduce
            _sync(dev)
            r["launches"] = launches()
            r["collectives"] = len(calls)
            _, r["ms_banded"] = timed(
                lambda: M.gather_rows(apply(M.shard_rows(x, dp), t), dp), 3)
            rows = x.shape[2] // MESH_RANKS
            r["banded_levels"] = M._Bands(M._group(dp, "data"), m,
                                          rows).banded
            r["planar"] = _mesh_planar_check(pu.calls, rank, rows,
                                             r["banded_levels"])
            del pu
        r["finite"] = bool(torch.isfinite(y).all())
        if rank == 0:
            r["rel_err"] = rel(y, want)
            del want
        del y
    del models
    dist.barrier()

    # 3. view-sharded FBP and FP (unsharded on rank 0)
    g, fan, _ = _mesh_geoms(size)
    pj = torch.as_tensor(rng.random((1, g.M, g.N)) * 4.0,
                         dtype=torch.float32, device=dev)
    fbp = M.make_view_sharded_fbp(vw, g)
    fbp(pj)    # warm: the FFT plans
    img, ms_fbp = timed(lambda: fbp(pj), 3)
    lut, betas = area_lut(fan), default_betas(fan)
    phantom = torch.as_tensor(shepp_logan(fan.nx), dtype=torch.float32,
                              device=dev)
    fp = M.make_view_sharded_fp(vw, fan, lut, betas)
    fp(phantom)
    sino, ms_fp = timed(lambda: fp(phantom))
    out["fbp"] = dict(views=g.M, ms=ms_fbp, finite=bool(
        torch.isfinite(img).all()))
    out["fp"] = dict(views=fan.na, ms=ms_fp, finite=bool(
        torch.isfinite(sino).all()))
    if rank == 0:
        ref, out["fbp"]["ms_unsharded"] = timed(lambda: fbp_convert(pj, g),
                                                3)
        out["fbp"]["rel_err"] = rel(img, ref)
        ref, out["fp"]["ms_unsharded"] = timed(
            lambda: forward_project(phantom, fan, lut, betas))
        out["fp"]["rel_err"] = rel(sino, ref)
    dist.barrier()
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_mesh(seed: int, out: str, dev: str = "cuda", size: int = 512):
    """``parallel/mesh.py`` on the card: 2 ranks of gloo on ``cuda:0``
    (NCCL refuses two ranks on one device), spawned after the parent
    built the kernels, each sharded result held to the unsharded one in
    f32 (cuDNN TF32 off): the img train preset's data-parallel step (2
    steps, global batch 2; losses and the first step's all-reduced
    gradients against ``make_train_step`` on rank 0; both ranks' params
    alike; then 2 warm steps timed, beside one process's at B = 2 and at
    B = 1); the H-sharded eval of the img UNet at 512² and the proj UNet
    at 2000×912 (the slices' widths, f32), each rank's planar_unit and
    flash launches > 0, and each rank's planar_unit calls on its halo'd
    bands held to the plain version with a planted control
    (:func:`_mesh_planar_check`); the view-sharded FBP at 2000 views and
    the FP.
    Then a 1-rank NCCL group: ``fit()`` of train_img with mesh_shape
    [1, 1] for 2 steps on the engine phase's corpus, the engine joining
    the group from torchrun's variables. Returns each rank's launches
    and the engine run's."""
    from ipdm_tpu_torch.parallel.spawn import run_ranks

    smi = nvidia_smi_line() if dev == "cuda" else "cpu"
    dev_name = "cuda:0" if dev == "cuda" else "cpu"
    log(f"mesh: {MESH_RANKS} ranks of gloo on {dev_name} ({smi}); two "
        f"ranks share one card, so these times measure no scaling")
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=out)
    t0 = time.perf_counter()
    res = run_ranks(_mesh_checks, MESH_RANKS, tmp,
                    (seed, dev_name, size), timeout=MESH_TIMEOUT)
    log(f"mesh: spawn to exit {time.perf_counter() - t0:.1f} s")
    _mesh_report(res, smi, dev == "cuda")
    engine = _mesh_engine(seed, out, dev, size)
    return [r_["evals"] for r_ in res], [r_["train"] for r_ in res], engine


def _mesh_report(res, smi, on_card: bool):
    """Print the ranks' results and fail where a check misses (the
    launch counts only on the card: the CPU runs the plain versions)."""
    r0 = res[0]
    tr = r0["train"]
    log(f"mesh: train img preset, global batch {MESH_RANKS} (1 a rank), "
        f"2 DDP steps: losses {tr['losses']} against one process "
        f"{tr['ref_losses']}; first step's gradients max|diff| "
        f"{tr['grad_rel']:.3e} of max|g|; param sums by rank "
        f"{tr['param_sums']}; TF32 off; {smi}")
    log(f"mesh: train ms/step, steps 1-2 (the first with cuDNN's set-up) "
        f"then {MESH_WARM_STEPS} warm: DDP rank 0 {tr['ms']} + "
        f"{tr['warm_ms']}, rank 1 {res[1]['train']['ms']} + "
        f"{res[1]['train']['warm_ms']} (two ranks of B = 1 at once on one "
        f"card); one process B = 2 {tr['ref_ms']}, B = 1 "
        f"{tr['ref_b1_ms']}; {smi}")
    bad = []
    if not np.allclose(tr["losses"], tr["ref_losses"], rtol=MESH_TOL):
        bad.append("train losses")
    if not tr["grad_rel"] <= MESH_TOL:
        bad.append("train gradients")
    if len(set(tr["param_sums"])) != 1:
        bad.append("ranks' params differ after the DDP steps")
    for r in res:
        for k in MESH_TRAIN_KERNELS if on_card else ():
            if not r["train"]["launches"].get(k, 0) > 0:
                bad.append(f"rank {r['rank']}: train launched no {k}")
    for name in ("img", "proj"):
        e = r0["evals"][name]
        log(f"mesh: {name} UNet {e['shape']} f32 on {MESH_RANKS} H-bands "
            f"({e['banded_levels']} levels banded, the rest gathered; "
            f"{e['collectives']} all-reduces a rank): "
            f"max|diff| {e['rel_err']:.3e} of max|unsharded| (tol "
            f"{MESH_TOL}); ms/eval banded {res[0]['evals'][name]['ms_banded']:.3f}"
            f" / {res[1]['evals'][name]['ms_banded']:.3f} (ranks 0 / 1, "
            f"concurrent on one card), unsharded "
            f"{e['ms_unsharded']:.3f}; launches by rank "
            f"{[r['evals'][name]['launches'] for r in res]}; {smi}")
        if not (e["rel_err"] <= MESH_TOL and all(
                r["evals"][name]["finite"] for r in res)):
            bad.append(f"{name} banded eval")
        for r in res:
            for k in MESH_EVAL_KERNELS[name] if on_card else ():
                if not r["evals"][name]["launches"].get(k, 0) > 0:
                    bad.append(f"rank {r['rank']}: {name} eval launched "
                               f"no {k}")
            pc = r["evals"][name]["planar"]
            if pc["calls"]:
                log(f"mesh: {name} eval rank {r['rank']}: {pc['calls']} "
                    f"planar_unit calls against the plain version, max "
                    f"|diff| {pc['max_abs_err']:.3e} (tol 1e-4 + "
                    f"1e-4·|plain|); {pc['banded_calls']} on halo'd bands "
                    f"{pc['heights']} rows, the control without the halo "
                    f"row off by {pc['control_min_err']:.3e} at the least "
                    f"(fails)")
            if (on_card and "planar_unit" in MESH_EVAL_KERNELS[name]
                    and not pc["banded_calls"] > 0):
                bad.append(f"rank {r['rank']}: no {name} planar_unit call "
                           f"on a halo'd band checked")
    for name in ("fbp", "fp"):
        e = r0[name]
        log(f"mesh: view-sharded {name.upper()} of {e['views']} views "
            f"({e['views'] // MESH_RANKS} a rank): max|diff| "
            f"{e['rel_err']:.3e} of max|unsharded| (tol {MESH_TOL}); ms "
            f"{res[0][name]['ms']:.1f} / {res[1][name]['ms']:.1f} (ranks "
            f"0 / 1, concurrent) against {e['ms_unsharded']:.1f} "
            f"unsharded; {smi}")
        if not (e["rel_err"] <= MESH_TOL and all(r[name]["finite"]
                                                 for r in res)):
            bad.append(f"view-sharded {name}")
    if bad:
        raise AssertionError(f"mesh: {bad}")


def _mesh_engine(seed: int, out: str, dev: str, size: int) -> dict:
    """``fit()`` of train_img with mesh_shape [1, 1] for 2 steps on the
    engine phase's corpus under ``out`` (save_freq 2: the checkpoints and
    test(1) on one slice, its UNet evals through the banded apply), in
    this process: the engine initialises the 1-rank group (NCCL on the
    card) from the variables torchrun would set. Returns its launches."""
    import torch
    import torch.distributed as dist
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
    from ipdm_tpu_torch.ops.cuda import _build

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ex = _example()
        opt = IPDMConfig().merge(_train_preset("img"))
        opt.merge(dict(device=dev, seed=seed, display_result=False,
                       mesh_shape=[1, 1], max_epochs=1, save_freq=2,
                       test_numbers=1, metrics=["psnr", "ssim"],
                       run_name="chip_smoke_mesh",
                       geometry=ex.geometry_overrides(size),
                       **ex.dataset_paths(out)))
        t0 = time.perf_counter()
        eng = ProgressiveDomainDenoiser(opt, result_save_path=out)
        backend = dist.get_backend()
        _build.reset_launches()
        eng.fit()
        _sync(dev)
        dt = time.perf_counter() - t0
        runs = {k: v for k, v in _build.LAUNCHES.items() if v}
        files = [osp.join(eng.logger.models_save_dir, f)
                 for f in ("img_model-1", "optimizer-1")]
        files.append(osp.join(eng.save_root_path, "Save_Iter_1",
                              "metric.json"))
        missing = [f for f in files if not osp.exists(f)]
        log(f"mesh: engine fit() train_img, mesh_shape [1, 1], a 1-rank "
            f"{backend} group from torchrun's variables, {opt.max_iter} "
            f"steps, checkpoints and test(1) on one slice: {dt:.1f} s "
            f"(with the engine's set-up); launches {runs}; files missing: "
            f"{missing}")
        if (backend != ("nccl" if dev == "cuda" else "gloo") or missing
                or opt.max_iter != 2 or not all(
                    runs.get(k, 0) > 0 for k in MESH_TRAIN_KERNELS
                    if dev == "cuda")):
            raise AssertionError("mesh: the 1-rank engine run")
        return runs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v



QUALITY_ARGV = ["--n", "16", "--size", "64", "--iters", "200",
                "--test-slices", "4", "--device", "cuda"]
# the kernels the contract run's path launches: project_fast of each
# phantom (#9; one image a call, so not #8), the corpus's OS-SART (#4,
# its plan's #5, #6 and the norms' #2), the FBP test's convert of its one
# kept iteration (#7), the ART test's sweeps, and planar_unit in both
# SMALL_ARCH UNets' stem (1 → 16 channels) and output (16 → 1)
# convolutions; no flash kernel (64 tokens at 64², under FLASH_MIN_SEQ)
QUALITY_KERNELS = ("fp_shift_deposit", "os_sart_sweep", "anterp_taps",
                   "fp_plane_deposit", "bp_shift", "bp_shift_accumulate",
                   "planar_unit")
# the settings of docs/PERF.md's "Full-scale quality demonstration": the
# SIEMENS scanner (512², 2000×912), the presets' widths (FULL_ARCH), an
# FBP-built corpus of 8 slices, 100 iterations (12 epochs of 8 slices)
QUALITY_FULL_ARGV = ["--n", "8", "--size", "512", "--full-arch", "--recon",
                     "FBP", "--iters", "100", "--test-slices", "4",
                     "--device", "cuda"]
# its path: project_fast of each phantom (#9 and its #5), the FBP of the
# corpus and of the test's kept iteration at B = 1 (#7), planar_unit in
# the proj UNet's narrow levels; no OS-SART, and no flash kernel (img
# attention at ds 16 has 1024 tokens, proj at ds 32 under 2000)
QUALITY_FULL_KERNELS = ("fp_shift_deposit", "anterp_taps",
                        "bp_shift_accumulate", "planar_unit")
# LDCT, deProj, deProg PSNR (dB) of the JAX package at these settings:
# docs/PERF.md's table for QUALITY_FULL_ARGV (a TPU), and the 64² runs
# of scripts/jax_quality_reading.py (a CPU; FBP, then ART on the same
# checkpoints)
JAX_QUALITY_FULL = (25.87, 25.86, 30.89)
JAX_QUALITY = {"FBP": (29.7011, 31.4041, 32.8132),
               "ART": (29.7011, 26.8666, 30.2175)}


def _quality_groups(m: dict) -> str:
    """LDCT / deProj / deProg PSNR and SSIM of an aggregate metric.json."""
    return "; ".join(
        f"{g} " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(m[g].items())
                            if not k.endswith("_std"))
        for g in ("LDCT", "deProj", "deProg"))


def _quality_run(label: str, argv, convs, kernels, jax_ref: dict,
                 seed: int, out: str) -> dict:
    """``examples/synthetic_e2e_torch.py``'s steps at ``argv``, through
    the engine as a user calls it: the corpus built on the card,
    ``ProgressiveDomainDenoiser(opt).fit()`` in train_img and train_proj,
    then test_prog on the same checkpoints with each convertor of
    ``convs``, the first the gated one: deProg > LDCT + 1 dB and deProj >
    LDCT − 3 dB. PyTorch's default precision, as the example runs (cuDNN
    in TF32). Prints each run's LDCT / deProj / deProg PSNR and SSIM
    beside the JAX package's (``jax_ref``), the seconds and launches of
    each step, the peak memory. Returns the launches (the counters set to
    0 just before the run); each kernel of ``kernels`` must have run."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build

    ex = _example()
    args = ex.parse_args(["--out", out, "--seed", str(seed)] + argv)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    marks = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()

        def mark(step):
            torch.cuda.synchronize()
            marks.append((step, time.perf_counter() - t0,
                          dict(_build.LAUNCHES)))

        ex.build_dataset(out, args.n, args.size, args.dose, seed=args.seed,
                         recon=args.recon, device=args.device)
        mark("corpus")
        common = ex.common_options(args)
        dirs = ex.train_models(args, common)
        mark("train img + proj")
        runs = {}
        for conv in convs:
            runs[conv] = ex.progressive_test(args, common, dirs, conv)
            mark(f"test_prog {conv}")
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    split, before, t_before = [], {k: 0 for k in launches}, 0.0
    for step, t, counts in marks:
        diff = {k: v - before[k] for k, v in counts.items() if v - before[k]}
        split.append(f"{step} {t - t_before:.3f} s {diff}")
        before, t_before = counts, t
    steps = 2 * common["max_epochs"] * args.n
    log(f"{label}: {args.n} slices {args.size}², "
        f"{'FULL_ARCH' if args.full_arch else 'SMALL_ARCH'}, {args.recon} "
        f"corpus, --iters {args.iters} ({common['max_epochs']} epochs at "
        f"batch 1, {steps} steps in all), test_prog on {args.test_slices} "
        f"slices; cuDNN TF32 on: {seconds:.3f} s, peak memory {peak:.3f} "
        f"GiB, {(marks[1][1] - marks[0][1]) / steps:.4f} s per step of "
        f"fit() (engines, checkpoints and logging included); "
        + "; ".join(split))
    for conv, (ldct, deproj, deprog, m) in runs.items():
        ref = jax_ref.get(conv)
        log(f"{label}: {conv}{' (gated)' if conv == convs[0] else ''}: "
            + _quality_groups(m)
            + (f"; the JAX package: LDCT {ref[0]} → deProj {ref[1]} → "
               f"deProg {ref[2]} dB" if ref else ""))
    ldct, deproj, deprog, _ = runs[convs[0]]
    log(f"{label}: {convs[0]} gates: deProg {deprog:.4f} > LDCT {ldct:.4f} "
        f"+ 1 dB: {deprog > ldct + 1.0} (margin {deprog - ldct - 1.0:+.4f} "
        f"dB); deProj {deproj:.4f} > LDCT − 3 dB: {deproj > ldct - 3.0}")
    log(f"{label}: launches {launches}")
    if not (deprog > ldct + 1.0 and deproj > ldct - 3.0):
        raise AssertionError(f"{label}: the trained port misses the "
                             f"contract: LDCT {ldct}, deProj {deproj}, "
                             f"deProg {deprog} dB")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    return launches


def phase_quality(seed: int, out: str):
    """The port's quality on the card, trained from seeded weights. The
    contract run (tests/test_quality.py's settings): a 16-slice 64²
    random-ellipse corpus, SMALL_ARCH UNets trained 200 iterations a
    domain, test_prog on 4 slices with the FBP convertor (gated) and the
    ART convertor. The full-width run (docs/PERF.md's full-scale
    demonstration): an 8-slice 512² corpus on the SIEMENS scanner, built
    by FBP, FULL_ARCH UNets trained 100 iterations a domain, test_prog on
    4 slices with the FBP convertor (gated). Returns each run's launches,
    the counters set to 0 just before it and read just after."""
    return (_quality_run("quality", QUALITY_ARGV, ("FBP", "ART"),
                         QUALITY_KERNELS, JAX_QUALITY, seed,
                         osp.join(out, "contract")),
            _quality_run("quality-full", QUALITY_FULL_ARGV, ("FBP",),
                         QUALITY_FULL_KERNELS, {"FBP": JAX_QUALITY_FULL},
                         seed, osp.join(out, "full")))


# -- the flash kernels at every head dim, the ablation studies,
# __graft_entry_torch__.py --------------------------------------------------

# the ablation UNets' middle block (head dim 8, 4 heads): the img UNet at
# 512² (128² tokens), the proj UNet on 2000×912 sinograms (500×228)
FLASH_HD_LONG = (16384, 114000)
# head dims between the instances, zero-padded by the wrappers: 24 on the
# hd-32 instance, 48 on 64 (model_channels 48), 96 on 128 (96)
FLASH_HD_PADDED = (24, 48, 96)
# the hd-128 instance's chained f32 sums, held at the proj UNet's token
# count and beyond it
FLASH_HD128_LONG = (7125, 16384)
LONG_BLOCK = 512                   # query rows per block of the plain loop
# the ablations phase's main-path run: the SIEMENS scanner's full size
# (--size 512: 512² images, 2000×912 sinograms) and examples/ablations.py's
# fixed UNets; depth cut in the slices, the iterations and the test slices
ABLATION_ARGV = ["--size", "512", "--study", "all", "--n", "4", "--iters",
                 "8", "--test-slices", "1"]
ABLATION_KERNELS = ("flash_attn_f32_hd8", "flash_bwd_dq_hd8",
                    "flash_bwd_dkv_hd8", "planar_unit", "os_sart_sweep",
                    "fp_shift_deposit")
ABLATION_STUDIES = ("nfe", "guidance", "recon", "hu-drift", "noise-hist",
                    "dose")
ABLATION_FUNCS = {"nfe": "study_nfe", "guidance": "study_guidance",
                  "recon": "study_recon", "hu-drift": "study_hu_drift",
                  "noise-hist": "study_noise_hist", "dose": "study_dose"}
ABLATION_SMALL = 32   # the card-vs-CPU check's size
# the card-vs-CPU check's planted controls, each an engine on the first
# device held to the first engine by the same check, which must miss in
# each listed study (hu-drift's two means are of the inputs, no control
# moves them): (noise seed offset, options set as the engine was built
# with them, studies). "noise": another noise draw; "lambda": the image
# sampler's λ moved by 2%, 0.45 → 0.46 (the guidance study sets its own)
ABLATION_CONTROLS = {
    "noise": (1, {}, ("nfe", "guidance", "recon", "noise-hist")),
    "lambda": (0, dict(constant_guidance_img=0.46),
               ("nfe", "recon", "noise-hist"))}


def _plain_long(q, k, v, do, scale, f64=True):
    """The plain forward and backward of attention on [BH, T, hd] inputs
    too long for the T × T matrix, one block of LONG_BLOCK query rows at a
    time over all keys (in f64; or, with ``f64=False``, the forward alone
    as attention_plain computes it in q's dtype): out, lse, dq per row;
    dk, dv summed over the blocks; R (lse_check's size of the scores) and
    Σ|terms before the cancellation| of dq, dk, dv (:func:`_bwd_sizes`)
    for the f64 witness rule."""
    import torch

    dt = torch.float64 if f64 else q.dtype
    BH, T, hd = q.shape
    ks, vv = (k.to(dt) * scale if f64 else k * scale), v.to(dt)
    out = torch.empty((BH, T, v.shape[-1]), dtype=dt, device=q.device)
    res = dict(out=out)
    if f64:
        for name in ("dq", "dk", "dv", "zq", "zk", "zv"):
            res[name] = torch.zeros((BH, T, hd), dtype=dt, device=q.device)
        res["lse"] = torch.empty((BH, T), dtype=dt, device=q.device)
        res["R"] = torch.empty((BH, T), dtype=dt, device=q.device)
        dof, va = do.to(dt), vv.abs()
    for r0 in range(0, T, LONG_BLOCK):
        sl = slice(r0, min(T, r0 + LONG_BLOCK))
        qs = q[:, sl].to(dt) * scale if f64 else q[:, sl] * scale
        s = torch.matmul(qs, ks.transpose(1, 2))
        if not f64:   # attention_plain on the block
            out[:, sl] = torch.matmul(torch.softmax(s, -1).to(q.dtype), vv)
            continue
        lse_b = torch.logsumexp(s, -1)
        res["lse"][:, sl] = lse_b
        p = torch.exp(s.sub_(lse_b[..., None]))
        del s
        o = torch.matmul(p, vv)
        out[:, sl] = o
        res["R"][:, sl] = (qs.abs() * torch.matmul(p, ks.abs())).sum(-1)
        dob = dof[:, sl]
        Db = (o * dob).sum(-1)
        dp = torch.matmul(dob, vv.transpose(1, 2))
        pre = p * (torch.matmul(dob.abs(), va.transpose(1, 2))
                   + (o.abs() * dob.abs()).sum(-1)[..., None])
        ds = p * dp.sub_(Db[..., None])
        del dp
        res["dq"][:, sl] = torch.matmul(ds, ks) * scale
        res["dk"] += torch.matmul(ds.transpose(1, 2), qs) * scale
        res["dv"] += torch.matmul(p.transpose(1, 2), dob)
        res["zq"][:, sl] = torch.matmul(pre, ks.abs()) * scale
        res["zk"] += torch.matmul(pre.transpose(1, 2), qs.abs()) * scale
        res["zv"] += torch.matmul(p.transpose(1, 2), dob.abs())
        del p, pre, ds
    return res


def flash_long(T, reps, hd=8):
    """The f32 kernels at head dim ``hd`` (8: the ablation UNets' middle
    block; 128: the new instance's chained sums) and 4 heads at long token
    counts, on seeded random q, k (sd 1), v (head h: mean h + 1) and
    dO, against the plain forward and backward in f64 over query blocks
    (:func:`_plain_long`): out at the f32 rule, the lse within lse_check's
    bound, dq, dk and dv at the f32 rule plus the f64 witness allowance
    (2⁻²⁰·Σ|terms before the cancellation|, :func:`bwd_ragged`'s), two
    launches bit-equal; beside planted controls that must fail: at head
    dim 8 the plain forward on q and k whose pad columns hold the next
    row's values, the lse in log2 units, and the dK kernel with D
    dropped. Times: the kernels, the plain forward over query blocks in
    f32, SDPA's forward and forward + backward, and each kernel's
    bound."""
    import torch
    from ipdm_tpu_torch.ops.cuda import attention

    BH = 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + T)
    scale = 1.0 / math.sqrt(math.sqrt(hd))

    def rnd(mean=0.0):
        return mean + torch.randn((BH, T, hd), generator=gen, device="cuda")
    q, k, do = rnd(), rnd(), rnd()
    v = rnd(torch.arange(1.0, BH + 1, device="cuda").view(BH, 1, 1))
    out, lse = attention._forward(q, k, v, scale, with_lse=True)
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, scale)
    out2, lse2 = attention._forward(q, k, v, scale, with_lse=True)
    dq2, D2 = attention.flash_bwd_dq(q, k, v, out, lse, do, scale)
    dk2, dv2 = attention.flash_bwd_dkv(q, k, v, lse, do, D2, scale)
    for name, a_, b_ in (("out", out, out2), ("lse", lse, lse2),
                         ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        repeat_check(f"flash-hd T={T} {name}", a_, b_)
    del out2, lse2, dq2, D2, dk2, dv2
    ctrl_dk, _ = attention.flash_bwd_dkv(q, k, v, lse, do,
                                         torch.zeros_like(D), scale)
    ref = _plain_long(q, k, v, do, scale)
    torch.cuda.synchronize()
    rtol, atol = flash_tol(ref["out"], "float32")
    out_over = float(((out.double() - ref["out"]).abs()
                      / (atol + rtol * ref["out"].abs())).max())
    ltol = LSE_EPS["float32"] * ref["R"] + T * 2.0 ** -23
    lse_over = float(((lse.double() - ref["lse"]).abs() / ltol).max())
    lse_ctrl = float(((lse.double() * math.log2(math.e) - ref["lse"]).abs()
                      / ltol).max())
    rel, share = BWD_TOL["float32"]
    over, alone = {}, {}
    for name, g in (("dq", dq), ("dk", dk), ("dv", dv)):
        w = ref[name]
        rule = share * float(w.abs().max()) + rel * w.abs()
        d = (g.double() - w).abs()
        alone[name] = float((d / rule).max())
        over[name] = float((d / (rule + RAGGED_F32_EPS
                                 * ref["z" + name[1]])).max())
    w = ref["dk"]
    dk_ctrl = float(((ctrl_dk.double() - w).abs()
                     / (share * float(w.abs().max()) + rel * w.abs()
                        + RAGGED_F32_EPS * ref["zk"])).max())
    err = dict(out=float((out.double() - ref["out"]).abs().max()),
               **{n: float((g.double() - ref[n]).abs().max())
                  for n, g in (("dq", dq), ("dk", dk), ("dv", dv))})
    del ref

    pad_ok, pad_err = False, None
    if hd < 16:   # the kernels' 16-column tiles: pad read from the next row
        def next_row_pad(x):
            return torch.cat([x, x.roll(-1, 1)[..., :16 - hd]], -1)
        pad = _plain_long(next_row_pad(q), next_row_pad(k), v, None, scale,
                          f64=False)["out"]
        pad_ok, pad_err = _within(pad, out.double(), rtol, atol)
        del pad
    # the plain versions: attention_plain and attention_bwd_plain where
    # their T × T matrices fit (T = 16 384: 4.3 GB each), else the plain
    # forward over query blocks (the backward's f32 plain is not timed)
    if T * T * BH * 4 <= 2 ** 33:
        plain_ms = cuda_ms(lambda: attention.attention_plain(
            q, k, v, scale), 1, warmup=1)
        plain_bwd_ms = cuda_ms(lambda: attention.attention_bwd_plain(
            q, k, v, out, lse, do, scale), 1, warmup=1)
    else:
        plain_ms = cuda_ms(lambda: _plain_long(q, k, v, None, scale,
                                               f64=False), 1, warmup=0)
        plain_bwd_ms = None
    t = dict(fwd_ms=cuda_ms(lambda: attention._forward(
                 q, k, v, scale, with_lse=True), reps),
             dq_ms=cuda_ms(lambda: attention.flash_bwd_dq(
                 q, k, v, out, lse, do, scale), reps),
             dkv_ms=cuda_ms(lambda: attention.flash_bwd_dkv(
                 q, k, v, lse, do, D, scale), reps),
             plain_ms=plain_ms, plain_bwd_ms=plain_bwd_ms,
             sdpa_fwd_ms=sdpa_ms(q, k, v, scale, reps),
             sdpa_fwd_bwd_ms=sdpa_ms(q, k, v, scale, reps, do=do))
    bounds = {kd: flash_bound(BH, T, hd, "float32", kd)
              for kd in ("fwd", "dq", "dkv")}
    sd = lambda x: "not run" if x is None else f"{x:.3f} ms"
    log(f"flash-hd: f32 [{BH},{T},{hd}] (plain over query blocks of "
        f"{LONG_BLOCK} in f64): out at {out_over:.4f} of the f32 rule "
        f"(max |diff| {err['out']:.3e}), lse at {lse_over:.4f} of its "
        f"bound; dq/dk/dv at {over['dq']:.3f} / {over['dk']:.3f} / "
        f"{over['dv']:.3f} of the f32 rule + 2⁻²⁰·Σ|terms| (the relative "
        f"rule alone: {alone['dq']:.3f} / {alone['dk']:.3f} / "
        f"{alone['dv']:.3f}); repeats bit-equal; planted controls: "
        + ("" if pad_err is None else
           f"the pad read from the next row max |diff| {pad_err:.3e} "
           f"({'passes' if pad_ok else 'fails'}), ")
        + f"the lse in log2 units "
        f"{lse_ctrl:.1f}×, D dropped {dk_ctrl:.1f}×; ms fwd "
        f"{t['fwd_ms']:.3f} (bound {bounds['fwd']:.3f}), dq "
        f"{t['dq_ms']:.3f} (bound {bounds['dq']:.3f}), dkv "
        f"{t['dkv_ms']:.3f} (bound {bounds['dkv']:.3f}); the plain forward "
        f"{plain_ms:.3f} ms, backward "
        + ("not run (T × T too large)" if plain_bwd_ms is None else
           f"{plain_bwd_ms:.3f} ms")
        + "; SDPA forward "
        f"{sd(t['sdpa_fwd_ms'])}, forward + backward "
        f"{sd(t['sdpa_fwd_bwd_ms'])}")
    if out_over > 1.0 or lse_over > 1.0 or max(over.values()) > 1.0:
        raise AssertionError(f"flash-hd T={T}: out {out_over}, lse "
                             f"{lse_over}, backward {over}")
    if pad_ok or lse_ctrl <= 1.0 or dk_ctrl <= 1.0:
        raise AssertionError(f"flash-hd T={T}: a planted control passes")
    return dict(T=T, hd=hd, err=err, over=dict(over, out=out_over,
                                               lse=lse_over),
                bound_ms=bounds, **t)


def head_dim_rows(rows, short, long, abl):
    """The kernels JSON line's rows of the head-dim-8 f32 kernels (the
    ablation path's: their launches in the ablations phase's main-path
    run; numbers at T = 16 384, where the plain versions fit, with
    T = 114 000 under ``shapes``), and each existing flash row's
    ``head_dims``: its kernel at head dims 8, 16 and 32 on the ragged
    inputs of phase_flash_hd (launched by no main path but the
    head-dim-8 f32 ones and the hd-128 f32 ones of the wide phase; a
    padded head dim's launches are its instance's)."""
    from ipdm_tpu_torch.ops.cuda import _build
    from ipdm_tpu_torch.ops.cuda.attention import flash_instance

    src = {"fwd": "ipdm_tpu_torch/csrc/flash_attn.cu",
           "dq": "ipdm_tpu_torch/csrc/flash_bwd.cu",
           "dkv": "ipdm_tpu_torch/csrc/flash_bwd.cu"}
    rep = {"fwd": "ipdm_tpu/models/unet.py:601",
           "dq": "ipdm_tpu/models/unet.py:601 → jax/experimental/pallas/"
                 "ops/tpu/flash_attention.py:1287",
           "dkv": "ipdm_tpu/models/unet.py:601 → jax/experimental/pallas/"
                  "ops/tpu/flash_attention.py:941"}
    names = {"fwd": "flash_attn_f32", "dq": "flash_bwd_dq",
             "dkv": "flash_bwd_dkv"}
    out = []
    for kind, base in names.items():
        name = _build.flash_counter(base, 8)
        lib = "sdpa_fwd_ms" if kind == "fwd" else "sdpa_fwd_bwd_ms"
        plain = "plain_ms" if kind == "fwd" else "plain_bwd_ms"
        errs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}[kind]
        shapes = [dict(T=x["T"], ms=x[f"{kind}_ms"], plain_ms=x[plain],
                       library_ms=x[lib], bound_ms=x["bound_ms"][kind],
                       max_abs_err=max(x["err"][e] for e in errs))
                  for x in long]
        top = shapes[0]
        out.append(dict(
            name=name, route="cuda", source=src[kind], replaces=rep[kind],
            launches=abl[name], max_abs_err=max(x["max_abs_err"]
                                                for x in shapes),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by="operations",
            library_ms=top["library_ms"], head_dim=8, dtype="float32",
            shapes=shapes))
        log(f"kernels: {name}: {abl[name]} launches in the ablations "
            f"phase's main-path run; at T = {top['T']} {top['ms']:.4f} ms "
            f"(plain {top['plain_ms']:.4f}, bound {top['bound_ms']:.4f}, "
            f"SDPA " + ("not run" if top["library_ms"] is None else
                        f"{top['library_ms']:.4f} ms") + ")")
        if abl[name] <= 0:
            raise AssertionError(f"{name} was not launched in the "
                                 f"ablations phase's main-path run")
    for row in rows:
        if row["name"] in ("flash_attn", "flash_attn_f32"):
            dtype = "bfloat16" if row["name"] == "flash_attn" else "float32"
            row["head_dims"] = [dict(
                hd=x["hd"], T=x["T"], ms=x["ms"], library_ms=x["library_ms"],
                bound_ms=x["bound_ms"], max_abs_err=x["err"],
                instance=flash_instance(x["hd"]),
                launches_ablations=abl[_build.flash_counter(
                    row["name"], flash_instance(x["hd"]))])
                for x in short if "ms" in x and x["dtype"] == dtype]
        elif row["name"] in ("flash_bwd_dq", "flash_bwd_dkv"):
            kind = row["name"][len("flash_bwd_"):]
            row["head_dims"] = [dict(
                hd=x["hd"], T=x["T"], dtype=x["dtype"], ms=x[f"{kind}_ms"],
                library_ms=x["library_ms"], bound_ms=x[f"{kind}_bound_ms"],
                max_abs_err=x["err"], over=x["over"],
                instance=flash_instance(x["hd"]),
                launches_ablations=abl[_build.flash_counter(
                    row["name"], flash_instance(x["hd"]))])
                for x in short if f"{kind}_ms" in x]
    return out


def phase_flash_hd(reps):
    """The flash kernels at head dims 8, 16, 32 and 128 and at the padded
    head dims 24, 48 and 96: the forward in bf16 and f32 and both
    backward kernels at T = 4097 and 7125 on the ragged inputs
    (:func:`flash_ragged`, :func:`bwd_ragged`, each beside its planted
    controls), then the f32 kernels at head dim 8 at the ablation UNets'
    T = 16 384 and 114 000 and at head dim 128 at T = 7125 and 16 384
    (:func:`flash_long`). Returns (the ragged stats, the long-T stats of
    head dim 8, those of head dim 128)."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    short = []
    r = max(2, reps // 4)
    with torch.no_grad():
        for hd in [h for h in _build.FLASH_HEAD_DIMS if h != 64] + list(
                FLASH_HD_PADDED):
            for dtype_name in ("bfloat16", "float32"):
                short += flash_ragged(r, dtype_name, (4097, 7125), hd,
                                      tag="flash-hd")
            short += bwd_ragged(r, (4097, 7125), hd, tag="flash-hd")
        long = [flash_long(T, 3) for T in FLASH_HD_LONG]
        long128 = [flash_long(T, 3, hd=128) for T in FLASH_HD128_LONG]
    log(f"flash-hd: {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return short, long, long128


def _ablation_numbers(res) -> str:
    """A study's JSON with floats to 4 places and histograms summed."""
    if isinstance(res, dict):
        return "{" + ", ".join(f"{k}: {_ablation_numbers(v)}"
                               for k, v in res.items()) + "}"
    if isinstance(res, list):
        return f"[{len(res)} values, sum {sum(res):g}]"
    return f"{res:.4f}" if isinstance(res, float) else str(res)


def phase_ablations(seed: int, out: str):
    """examples/ablations_torch.py's main at the scanner's full size on the
    card (:data:`ABLATION_ARGV`): all six studies, with the launch counts
    set to 0 just before main and read just after; each study's seconds,
    launches and JSON; peak memory. Raises if a kernel of
    :data:`ABLATION_KERNELS` was not launched. Then the 32² card-vs-CPU
    check (:func:`_ablation_card_vs_cpu`). Returns the main-path run's
    launches."""
    import torch
    from examples import ablations_torch as abl
    from ipdm_tpu_torch.ops.cuda import _build

    smi = nvidia_smi_line()
    per = {}
    funcs = {n: getattr(abl, f) for n, f in ABLATION_FUNCS.items()}

    def timed(name, fn):
        def run(*a):
            before = dict(_build.LAUNCHES)
            _sync("cuda")
            t0 = time.perf_counter()
            res = fn(*a)
            _sync("cuda")
            per[name] = dict(s=time.perf_counter() - t0, launches={
                k: v - before[k] for k, v in _build.LAUNCHES.items()
                if v - before[k]})
            return res
        return run

    d = osp.join(out, "ablations")
    for n, f in ABLATION_FUNCS.items():
        setattr(abl, f, timed(n, funcs[n]))
    try:
        _peak_reset("cuda")
        _build.reset_launches()
        t0 = time.perf_counter()
        abl.main(["--out", d, "--device", "cuda", "--seed", str(seed),
                  *ABLATION_ARGV])
        _sync("cuda")
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        for n, f in ABLATION_FUNCS.items():
            setattr(abl, f, funcs[n])
    peak = _peak_gib("cuda")
    log(f"ablations: main({' '.join(ABLATION_ARGV)}) on the card: "
        f"{secs:.1f} s, peak memory {peak:.2f} GiB ({smi})")
    for name in ABLATION_STUDIES:
        with open(osp.join(d, f"ablation_{name}.json")) as f:
            res = json.load(f)
        log(f"ablations: {name}: {per[name]['s']:.1f} s, launches "
            f"{per[name]['launches']}; {_ablation_numbers(res)}")
    log(f"ablations: launches in the main-path run "
        f"{ {k: v for k, v in launches.items() if v} }")
    missing = [k for k in ABLATION_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"ablations: {missing} not launched")
    _ablation_card_vs_cpu(seed, out)
    return launches


def _same_study(got, want, path, bad):
    """Card-vs-CPU of one study's JSON: floats within 1e-3 relative,
    histograms within 1% of the pixel count in L1; mismatches into
    ``bad``."""
    if isinstance(want, dict):
        if got.keys() != want.keys():
            bad.append((path, "keys"))
            return
        for k in want:
            _same_study(got[k], want[k], f"{path}/{k}", bad)
    elif isinstance(want, list):
        if path.endswith("bins"):
            if got != want:
                bad.append((path, "bins"))
        elif (sum(abs(a - b) for a, b in zip(got, want))
              > 0.01 * ABLATION_SMALL ** 2):
            bad.append((path, got, want))
    elif isinstance(want, float):
        if not (math.isfinite(got)
                and abs(got - want) <= 1e-3 * max(abs(want), 1e-12)):
            bad.append((path, got, want))
    elif got != want:
        bad.append((path, got, want))


def _ablation_card_vs_cpu(seed: int, out: str,
                          devs=("cuda", "cpu")) -> None:
    """At 32², f32 with TF32 off: one card engine and one CPU engine built
    by the twin's _test_engine from the same seeded checkpoints, each
    sampler drawing the same noise (:func:`_shared_noise`); the five
    engine studies on each in main's order; every float of each JSON
    within 1e-3 relative, each histogram within an L1 distance of 1% of
    the pixel count. Not at zero noise: there the chain is
    ill-conditioned (a one-ulp change of the CPU's own sinogram moved its
    noise histogram by L1 18 of 1024 pixels and a float by 3.2e-4; with
    one shared noise by nothing and 1.6e-7), and the card missed the
    rule at dense_3x15's PSNR (3.5e-3) and the histogram (L1 14). Beside
    it the planted controls (:data:`ABLATION_CONTROLS`): engines on the
    first device drawing another noise, or with the image λ moved by 2%,
    must each miss the same check in the studies listed. (``devs``: a CPU
    rehearsal passes ("cpu", "cpu").)"""
    import torch
    from examples import ablations_torch as abl
    from examples.synthetic_e2e_torch import (build_dataset, dataset_paths,
                                              geometry_overrides,
                                              write_checkpoints)
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.diffusion import diffusion

    t0 = time.perf_counter()
    d = osp.join(out, "ablations_small")
    build_dataset(osp.join(d, "data"), 2, ABLATION_SMALL, DOSE, seed=seed,
                  device="cpu")
    common = dict(seed=seed, batch_size=1, save_freq=1, test_numbers=0,
                  init_lr=2e-4, geometry=geometry_overrides(ABLATION_SMALL),
                  metrics=["psnr", "ssim"], patch=None, patch_per_image=None,
                  timesteps_img=1000, partial_timesteps_img=50,
                  timesteps_proj=1000, partial_timesteps_proj=50,
                  max_epochs=1, **abl.ARCH,
                  **dataset_paths(osp.join(d, "data")))
    ckpt = write_checkpoints(d, IPDMConfig(device="cpu", **common),
                             seed=seed, device="cpu")
    args = collections.namedtuple("Args", "test_slices")(1)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    noise_like = diffusion.noise_like
    res = {}
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        runs = [(0, devs[0], 0, {}), (1, devs[1], 0, {})] + [
            (k, devs[0], dn, opts)
            for k, (dn, opts, _) in ABLATION_CONTROLS.items()]
        for key, dev, dn, opts in runs:
            diffusion.noise_like = _shared_noise(seed + dn)
            eng = abl._test_engine(osp.join(d, str(key)),
                                   dict(common, device=dev), ckpt, ckpt)
            for k, v in opts.items():   # as built: reset_opt keeps it
                setattr(eng.opt, k, v)
                setattr(eng.opt_temp, k, v)
            res[key] = {n: getattr(abl, ABLATION_FUNCS[n])(args, eng)
                        for n in ABLATION_STUDIES[:5]}
    finally:
        diffusion.noise_like = noise_like
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    bad = []
    for n in ABLATION_STUDIES[:5]:
        _same_study(res[1][n], res[0][n], f"/{n}", bad)
    misses, passed = {}, []
    for k, (_, _, studies) in ABLATION_CONTROLS.items():
        misses[k] = {}
        for n in ABLATION_STUDIES[:5]:
            miss = []
            _same_study(res[k][n], res[0][n], f"/{n}", miss)
            misses[k][n] = len(miss)
        passed += [(k, n) for n in studies if not misses[k][n]]

    def worst(a):
        return max(abs(g - w) / max(abs(w), 1e-12)
                   for n in ABLATION_STUDIES[:5]
                   for g, w in _floats(res[a][n], res[0][n]))
    log(f"ablations: {ABLATION_SMALL}² card vs CPU, one shared noise, the "
        f"five engine studies in main's order: largest relative "
        f"difference of a float {worst(1):.3e} (tol 1e-3), histograms "
        f"within 1% of the pixels in L1: {'all' if not bad else bad}; "
        f"planted controls on {devs[0]} against the first engine: "
        + "; ".join(f"{k} largest {worst(k):.3e}, entries missed by study "
                    f"{misses[k]}" for k in ABLATION_CONTROLS)
        + f"; {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"ablations card vs CPU: {bad}")
    if passed:
        raise AssertionError(f"ablations card vs CPU: a planted control "
                             f"passes: {passed}")


def _shared_noise(seed: int):
    """A noise_like that returns, for its n-th call, the standard normal
    draws of a CPU generator seeded with (seed, n), on the tensor's
    device: the same noise for two engines on two devices."""
    import torch
    calls = itertools.count(1)

    def noise_like(x, generator):
        g = torch.Generator().manual_seed(seed * 1_000_003 + next(calls))
        return torch.randn(x.shape, generator=g, dtype=x.dtype).to(x.device)
    return noise_like


def _floats(got, want):
    """Pairs of the floats of two study JSONs, in order."""
    if isinstance(want, dict):
        for k in want:
            yield from _floats(got[k], want[k])
    elif isinstance(want, float):
        yield got, want


def phase_graft(seed: int) -> None:
    """__graft_entry_torch__.py on the card: entry()'s step at zero noise
    against the same step on the CPU with the card model's weights (f32,
    TF32 off: within 1e-4 + 1e-4·|CPU|), then dryrun_multichip(2) on two
    gloo ranks that share the card."""
    import torch
    from ipdm_tpu_torch.diffusion import diffusion
    from ipdm_tpu_torch.ops.cuda import _build

    import __graft_entry_torch__ as graft   # the ranks import it by name

    t0 = time.perf_counter()
    fn, args = graft.entry()
    cfn, cargs = graft.entry(device="cpu")
    cargs[0].load_state_dict({k: v.cpu()
                              for k, v in args[0].state_dict().items()})
    tf32 = torch.backends.cudnn.allow_tf32
    noise_like = diffusion.noise_like
    try:
        torch.backends.cudnn.allow_tf32 = False
        diffusion.noise_like = lambda x, generator: torch.zeros_like(x)
        _build.reset_launches()
        got = fn(*args)
        _sync("cuda")
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        want = cfn(*cargs)
    finally:
        diffusion.noise_like = noise_like
        torch.backends.cudnn.allow_tf32 = tf32
    ok, err = _within(got.cpu(), want, 1e-4, 1e-4)
    log(f"graft: entry() step {tuple(got.shape)} on the card against the "
        f"CPU, zero noise: max |diff| {err:.3e} (tol 1e-4 + 1e-4·|CPU|), "
        f"finite {bool(torch.isfinite(got).all())}, launches {launches}")
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"graft: entry() on the card: {err}")
    if launches.get("planar_unit", 0) <= 0:
        raise AssertionError("graft: entry() launched no planar_unit")
    r = graft.dryrun_multichip(2)
    log(f"graft: dryrun_multichip(2) on two gloo ranks sharing the card: "
        f"mesh {r['mesh']}, loss {r['loss']:.5f}, sp-eval max|d| "
        f"{r['eval_d']:.2e}, sharded-sampler max|d| {r['sampler_d']:.2e}; "
        f"graft phase {time.perf_counter() - t0:.1f} s")


# -- part B: UNets wider than the presets, and the multi-process twin -------

# model_channels of both UNets in the wide phase, the head dim of every
# flash block (4 heads over 4·mc channels): 128 runs the hd-128 instance,
# 96 the same instance zero-padded, 48 the hd-64 instance zero-padded
WIDE_WIDTHS = (128, 96, 48)
WIDE_TRAIN_STEPS = 3   # fit() steps of each domain at width 128


def _pad_from_next_row(x, inst):
    """x [BH, T, hd] padded to ``inst`` columns with the next row's first
    columns: what a kernel would read past a row's end with the wrong
    stride (a planted fault of the zero padding)."""
    import torch
    return torch.cat([x, x.roll(-1, 1)[..., :inst - x.shape[-1]]], -1)


def _wide_slice(w, ld_proj, seed, reps):
    """One width of :func:`phase_wide`: the slice, its launches and the
    forward checks on its recorded q, k, v."""
    import torch
    from ipdm_tpu_torch.engine.denoiser import (make_convertor,
                                                progressive_denoiser)
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import _build, attention

    opt = dict(shipped_preset(), compute_dtype="float32",
               model_channels_img=w, model_channels_proj=w)
    inst = attention.flash_instance(w)
    name = _build.flash_counter("flash_attn_f32", inst)
    torch.manual_seed(seed)
    models = [build_unet(opt, d, device="cuda").eval()
              for d in ("proj", "img")]

    def run(s):
        gen = torch.Generator(device="cuda").manual_seed(s)
        return progressive_denoiser(opt, *models, ld_proj, gen)

    t0 = time.perf_counter()
    run(seed + 1)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with Recorder(unet, "flash_attention",
                  key=lambda a: tuple(a[0].shape)) as fa:
        t0 = time.perf_counter()
        out = run(seed + 2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flash = {k: v for k, v in launches.items()
             if k.startswith("flash") and v}
    finite = bool(torch.isfinite(out).all())
    log(f"wide: mc {w} (head dim {w}, instance {inst}): a warm ART slice "
        f"{dt:.4f} s (the first, at these shapes, {first:.4f} s), output "
        f"{tuple(out.shape)} finite={finite}, peak memory {peak:.2f} GiB; "
        f"flash launches by instance {flash}; planar_unit "
        f"{launches['planar_unit']}")
    n = make_convertor(opt).fbp_geom.grid_n
    if tuple(out.shape) != (1, n, n, 1) or not finite:
        raise AssertionError(f"wide mc {w}: output {tuple(out.shape)} "
                             f"finite={finite}")
    if launches[name] <= 0 or set(flash) != {name}:
        raise AssertionError(f"wide mc {w}: flash launches {flash}, "
                             f"expected {name} alone")
    del models, out
    with torch.no_grad():
        stats = flash_f32_check("wide", fa.calls, reps)
        for (args, _), st in zip(fa.calls, stats):
            q, k, v, scale = args
            st["hd"], st["instance"] = w, inst
            if inst == w:
                continue
            # the zero padding's planted fault: the pad columns of q and k
            # from the next row, through the plain version
            want = attention.attention_plain(q, k, v, scale)
            bad = attention.attention_plain(
                _pad_from_next_row(q, inst), _pad_from_next_row(k, inst),
                attention._pad(inst, v)[0], scale)[..., :w]
            rtol, atol = flash_tol(want, "float32")
            ok, err = _within(bad, want, rtol, atol)
            log(f"wide: mc {w} T={q.shape[1]}: planted control, the pad "
                f"columns of q and k from the next row: max |diff| "
                f"{err:.3e}, {'passes' if ok else 'fails'}")
            if ok:
                raise AssertionError(f"wide mc {w}: the padding control "
                                     f"passes")
    return dict(s=dt, first_s=first, peak_gib=peak, launches=launches,
                name=name, stats=stats)


def phase_wide(seed: int, out: str, ld_proj, reps: int):
    """The shipped test preset (f32 as shipped, cuDNN in TF32 as
    main_torch.py runs) with model_channels_img and model_channels_proj at
    each of :data:`WIDE_WIDTHS`, seeded random weights: per width a first
    ART slice through progressive_denoiser at these shapes, then a warm
    one with the launch counters set to 0 just before it and read just
    after (s/slice, peak memory, the flash launches by instance: only the
    instance of that head dim), and the f32 forward on its recorded q, k,
    v (T = 7125 and 4096) by :func:`flash_f32_check`, beside a planted
    fault of the padding at 96 and 48. Then at width 128, fit() of
    train_img and train_proj for :data:`WIDE_TRAIN_STEPS` steps each (f32,
    B = 1, remat, the engine phase's corpus), whose first backward's
    inputs feed :func:`bwd_call_stats`. Returns the hd-128 rows of the
    kernels JSON line."""
    import torch
    from ipdm_tpu_torch.ops.cuda import _build, attention

    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        slices = {w: _wide_slice(w, ld_proj, seed, max(2, reps // 4))
                  for w in WIDE_WIDTHS}
        paths = _example().dataset_paths(out)
        runs, bwd = {}, []
        for domain in ("img", "proj"):
            with Recorder(attention, "flash_bwd_dq", limit=1) as rec:
                eng, steps, runs[domain], t_fit = _train_run(
                    domain, out, seed, paths, overrides={
                        f"model_channels_{domain}": 128, "save_freq": 1000,
                        "test_numbers": 0,
                        "run_name": f"chip_smoke_wide_{domain}"},
                    max_iter=WIDE_TRAIN_STEPS)
            del eng
            bwd += rec.calls
            losses = [st["loss"] for st in steps]
            warm = [st["s"] for st in steps[1:]]
            per_step = steps[-1]["launches"]
            log(f"wide: train_{domain} at mc 128, {len(steps)} steps: losses "
                + ", ".join(f"{x:.5f}" for x in losses)
                + f"; warm {sum(warm) / len(warm):.4f} s/step (first "
                f"{steps[0]['s']:.4f} s); peak memory of a step "
                f"{max(st['peak'] for st in steps):.2f} GiB; launches per "
                f"step {per_step}")
            want = [_build.flash_counter(k, 128) for k in (
                "flash_attn_f32", "flash_bwd_dq", "flash_bwd_dkv")]
            if (len(steps) != WIDE_TRAIN_STEPS
                    or not all(math.isfinite(x) for x in losses)
                    or any(per_step.get(k, 0) <= 0 for k in want)):
                raise AssertionError(f"wide train_{domain}: {len(steps)} "
                                     f"steps, losses {losses}, launches "
                                     f"{per_step}")
        with torch.no_grad():
            per = [bwd_call_stats("wide", "float32", args, reps)
                   for args, _ in bwd]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    log(f"wide: {time.perf_counter() - t0:.1f} s")
    return wide_rows(slices, runs, per)


def wide_rows(slices, runs, per):
    """The kernels JSON line's rows of the hd-128 f32 instances: the
    forward's launches in the width-128 slice's warm run, its numbers on
    that run's q, k, v (T = 7125 and 4096 under ``shapes``) and the
    padded widths' under ``padded``; the backward pair's launches in the
    two width-128 train runs and its numbers on their first backward."""
    from ipdm_tpu_torch.ops.cuda import _build

    rows = []
    top = slices[128]
    summarise(rows, "wide", top["name"], "ipdm_tpu_torch/csrc/flash_attn.cu",
              "ipdm_tpu/models/unet.py:601", top["stats"], True)
    rows[-1].update(
        launches=top["launches"][top["name"]], head_dim=128,
        dtype="float32", shapes=f32_shapes(top["stats"]),
        padded=[dict(hd=w, instance=slices[w]["stats"][0]["instance"],
                     launches=slices[w]["launches"][slices[w]["name"]],
                     counter=slices[w]["name"],
                     shapes=f32_shapes(slices[w]["stats"]))
                for w in WIDE_WIDTHS if w != 128],
        slices={w: dict(s=x["s"], peak_gib=x["peak_gib"])
                for w, x in slices.items()})
    for i, kind in enumerate(("dq", "dkv")):
        name = _build.flash_counter(f"flash_bwd_{kind}", 128)
        st = [p[i] for p in per]
        summarise(rows, "wide", name, "ipdm_tpu_torch/csrc/flash_bwd.cu",
                  "ipdm_tpu/models/unet.py:601 → jax/experimental/pallas/"
                  "ops/tpu/flash_attention.py:"
                  + ("1287" if kind == "dq" else "941"), st, True)
        rows[-1].update(
            launches=runs["img"][name] + runs["proj"][name],
            launches_train_img=runs["img"][name],
            launches_train_proj=runs["proj"][name], head_dim=128,
            dtype="float32",
            library="SDPA forward + backward of the same q, k, v, dO",
            shapes=[dict(T=x["T"], ms=x["ms"], plain_ms=x["plain_ms"],
                         library_ms=x["library_ms"],
                         bound_ms=max(x["bytes_ms"], x["ops_ms"]),
                         max_abs_err=x["err"]) for x in st])
    for row in rows:
        log(f"kernels: {row['name']}: {row['launches']} launches in the "
            f"wide phase's main-path runs")
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched in the "
                                 f"wide phase")
    return rows


MULTIHOST_TIMEOUT = 300   # s for the twin's two processes on the card


def phase_multihost() -> None:
    """scripts/multihost_dryrun_torch.py on the card: two processes that
    meet by env:// as torchrun's do, join through the engine's
    _join_mesh (gloo, both on cuda:0), and run its four checks; its last
    line must read ok with 2 processes."""
    t0 = time.perf_counter()
    script = osp.join(osp.dirname(osp.abspath(__file__)), "scripts",
                      "multihost_dryrun_torch.py")
    res = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=MULTIHOST_TIMEOUT)
    for line in res.stderr.strip().splitlines()[-12:]:
        log(f"multihost: {line}")
    last = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"multihost: {last}, {time.perf_counter() - t0:.1f} s")
    if res.returncode or not last.get("ok") or last.get("processes") != 2:
        raise AssertionError(f"multihost: {last}")


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
    bp_row = rows[-1]
    grad_calls = phase_grad(models, ld_proj, SEED)
    phase_reference(SEED)
    fbp, _, _ = phase_slice("FBP", SLICE_OPT, models, ld_proj, SEED,
                            FBP_KERNELS, 90, n_timed=1)
    art_calls, per_plan = phase_record_art(ld_proj)
    rows += phase_kernels_art(art_calls, REPS, bp_row)
    phase_reference_art(SEED)
    art, warm, _ = phase_slice("ART", ART_SLICE_OPT, models, ld_proj, SEED,
                               ART_KERNELS, 105, n_timed=2, fresh_plan=True)
    phase_exact(models, SEED, REPS)
    f32_row = phase_slice_f32(ld_proj, SEED, REPS)
    ddim = phase_slice_ddim(ld_proj, SEED, REPS, next(
        r for r in rows if r["name"] == "os_sart_sweep"))
    fp_calls, fp_run, bf16_run = phase_record_fp(SEED)
    rows += phase_kernels_fp(fp_calls, art_calls, REPS)
    phase_reference_fp(SEED)
    unfused = phase_unfused(SEED, REPS)
    del models
    with tempfile.TemporaryDirectory(prefix="ipdm_engine_") as out:
        eng_run, fbp_one, bp1_calls, corpus_calls = phase_engine(SEED, out)
        phase_kernels_corpus(corpus_calls, REPS, next(
            r for r in rows if r["name"] == "os_sart_sweep"))
        rows += phase_kernels_bp1(
            bp1_calls, art_calls["bp_shift_accumulate_batched"], REPS)
        phase_figures(SEED, out)
        fwd_calls, bwd_calls, train_runs = phase_train(SEED, out)
        mesh_evals, mesh_train, mesh_engine = phase_mesh(SEED, out)
        quality, quality_full = phase_quality(SEED,
                                              osp.join(out, "quality"))
        abl = phase_ablations(SEED, out)
        wide = phase_wide(SEED, out, ld_proj, REPS)
    train_rows, train_fwd = phase_kernels_train(
        fwd_calls, bwd_calls, grad_calls, train_runs, REPS)
    hd_short, hd_long, hd_long128 = phase_flash_hd(REPS)
    phase_graft(SEED)
    phase_multihost()
    # the f32 forward's row is the f32 ART slice's (its main path); the
    # train runs' counts and checked shapes beside them
    f32_row["launches_train_img"] = train_runs["img"]["flash_attn_f32"]
    f32_row["launches_train_proj"] = train_runs["proj"]["flash_attn_f32"]
    f32_row["train_shapes"] = f32_shapes(train_fwd)
    f32_row["launches_ddim"] = ddim["flash_attn_f32"]
    train_rows.insert(0, f32_row)
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
        row["launches_ddim"] = ddim[name]    # the DDIM slice's main path
        if name in ("fp_plane_deposit", "anterp_taps", "bp_shift"):
            # the first convert's launches less those of a warm one
            row["launches_per_plan"] = per_plan[name] - warm[name]
        log(f"kernels: {name}: {row['launches']} launches in its main-path "
            f"run; {art[name]} in the ART slice's (plan built in it), "
            f"{warm[name]} per warm ART slice, {fbp[name]} per FBP slice, "
            f"{eng_run[name]} in the engine's run of 2 slices, "
            f"{fp_run[name]} in the batched project_fast, {ddim[name]} in "
            f"the DDIM slice's")
        if row["launches"] <= 0:
            raise AssertionError(f"{name} was not launched in its "
                                 f"main-path run")
    # the train phase's kernels: their launches in the two train runs
    # (each with the counters set to 0 just before fit() and read just
    # after); planar_unit's and flash_attn's train-run counts beside them
    for row in rows:
        if row["name"] in ("planar_unit", "flash_attn"):
            row["launches_train_proj"] = train_runs["proj"][row["name"]]
    for row in train_rows:
        where = ("the f32 ART slice's main-path run; in the train runs"
                 if row is f32_row else "the train runs")
        log(f"kernels: {row['name']}: {row['launches']} launches in "
            f"{where} (img {row['launches_train_img']}, proj "
            f"{row['launches_train_proj']})"
            + (f"; {row['launches_ddim']} in the DDIM slice's main-path run"
               if row is f32_row else ""))
        if (row["launches"] <= 0 or row["launches_train_img"] <= 0
                or row["launches_train_proj"] <= 0):
            raise AssertionError(f"{row['name']} was not launched in "
                                 f"{where}")
    rows += train_rows
    # the mesh phase's launches: each rank's banded evals (img + proj) and
    # DDP train steps, and the 1-rank engine run; each read just after
    # its run, the counters set to 0 just before it
    for row in rows:
        name = row["name"]
        if name in ("planar_unit",) + MESH_TRAIN_KERNELS:
            row["launches_mesh"] = dict(
                eval_by_rank=[sum(e[d]["launches"].get(name, 0)
                                  for d in ("img", "proj"))
                              for e in mesh_evals],
                train_by_rank=[t["launches"].get(name, 0)
                               for t in mesh_train],
                engine_1rank=mesh_engine.get(name, 0))
            if name == "planar_unit":
                # its calls on the halo'd bands, against the plain version
                row["launches_mesh"]["eval_checked_calls"] = sum(
                    e[d]["planar"]["calls"] for e in mesh_evals
                    for d in ("img", "proj"))
                row["launches_mesh"]["eval_max_abs_err"] = max(
                    e[d]["planar"]["max_abs_err"] for e in mesh_evals
                    for d in ("img", "proj"))
            log(f"kernels: {name}: under the mesh {row['launches_mesh']}")
    # the unfused phase's converts, each run with the counters set to 0
    # just before it and read just after (plan and norms built in it):
    # launches_unfused in sart_fast_convert(fused=False), launches_unfolded
    # in the two fold=False converts; the shapes checked there
    unf = unfused["launches"]
    for row in rows:
        name = row["name"]
        if name not in unfused["shapes"]:
            continue
        if name != "os_sart_sweep":
            row["launches_unfused"] = unf["unfused"][name]
        row["launches_unfolded"] = (unf["fused_unfolded"][name]
                                    + unf["unfused_unfolded"][name])
        row["shapes_unfused"] = unfused["shapes"][name]
        log(f"kernels: {name}: "
            + (f"{row['launches_unfused']} launches in the unfused convert's "
               f"run, " if "launches_unfused" in row else "")
            + f"{row['launches_unfolded']} in the two unfolded converts' "
            f"(fused {unf['fused_unfolded'][name]}, unfused "
            f"{unf['unfused_unfolded'][name]})")
        if (row.get("launches_unfused", 1) <= 0
                or row["launches_unfolded"] <= 0):
            raise AssertionError(f"{name} was not launched in the unfused "
                                 f"phase's converts")
    # the quality phase's launches, each run's counters set to 0 just
    # before it and read just after (corpus, both train runs, the test
    # runs): the 64² contract run and the full-width run
    for row in rows:
        row["launches_quality"] = quality[row["name"]]
        row["launches_quality_full"] = quality_full[row["name"]]
    log("kernels: launches in the quality phase (64² contract / full "
        "width): " + ", ".join(
            f"{row['name']} {row['launches_quality']} / "
            f"{row['launches_quality_full']}" for row in rows))
    rows += head_dim_rows(rows, hd_short, hd_long, abl)
    # the ablations phase's main-path run (ablations_torch.main at the
    # scanner's full size), its counters set to 0 just before it and read
    # just after
    for row in rows:
        row["launches_ablations"] = abl[row["name"]]
    log("kernels: launches in the ablations phase's main-path run: "
        + ", ".join(f"{row['name']} {row['launches_ablations']}"
                    for row in rows))
    # the wide phase's hd-128 rows; the hd-128 f32 trio at long T
    for row in wide:
        part = {"flash_attn_f32_hd128": "fwd", "flash_bwd_dq_hd128": "dq",
                "flash_bwd_dkv_hd128": "dkv"}[row["name"]]
        row["shapes_long"] = [dict(
            T=x["T"], ms=x[f"{part}_ms"], bound_ms=x["bound_ms"][part],
            library_ms=x["sdpa_fwd_ms" if part == "fwd"
                         else "sdpa_fwd_bwd_ms"],
            over=x["over"]) for x in hd_long128]
    rows += wide
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

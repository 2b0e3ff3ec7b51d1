#!/usr/bin/env python3
"""Time the ablations' main-path run for a parent checkout and this tree
on one NVIDIA GPU, in the order parent, new, new, parent.

    python3 scripts/ablations_ab.py --parent DIR [--seed 0] [--out F]

DIR is a checkout of the parent commit (``git archive <commit> | tar -x
-C DIR``). The run is chip_smoke.py's ``ablations:`` main path:
``examples/ablations_torch.py`` with ABLATION_ARGV (the scanner's full
size, all six studies). Each of the four runs is a process of its own,
started in its tree's root so that it imports and builds that tree's
package. A process builds its kernels, warms the card up with one short
main (the hu-drift study alone, not timed), then times main with every
study's seconds (the card synchronised before and after), and counts
the UNets' flash_attention calls by (T, head dim, dtype) and the flash
backward's launches (``flash_bwd_dq``, ``flash_bwd_dkv``) by (T, head
dim). The first process of each tree then runs main once more under
torch.profiler and sums the device time of each kernel whose name holds
``flash`` or ``split`` (launches, ms), and of those the forward's and the
backward's at head dim 8 (``bwd_hd8_ms``: flash_bwd_dot_kernel and the
backward kernels and pre-passes that the hd-8 f32 backward launches, in
either tree): their share of the run.

The last line is a JSON object with every run; with ``--out`` it is also
written to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(root: Path, seed: int, argv: list, profile: bool) -> dict:
    """One tree's run, in this process (its cwd and sys.path at root)."""
    import collections
    import tempfile
    import time

    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from examples import ablations_torch as abl
    from ipdm_tpu_torch.models import unet
    from ipdm_tpu_torch.ops.cuda import _build, attention

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    calls = collections.Counter()
    flash = unet.flash_attention

    def counted(q, k, v, scale):
        calls[f"T {q.shape[1]} hd {q.shape[2]} {str(q.dtype)[6:]}"] += 1
        return flash(q, k, v, scale)

    bwd_calls = collections.Counter()
    bwd = {n: getattr(attention, n) for n in ("flash_bwd_dq",
                                              "flash_bwd_dkv")}

    def bwd_counted(name):
        def run(q, *a):
            bwd_calls[f"{name} T {q.shape[1]} hd {q.shape[2]}"] += 1
            return bwd[name](q, *a)
        return run

    per = {}

    def timed(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            per[name] = round(time.perf_counter() - t, 3)
            return res
        return run

    studies = {"nfe": "study_nfe", "guidance": "study_guidance",
               "recon": "study_recon", "hu-drift": "study_hu_drift",
               "noise-hist": "study_noise_hist", "dose": "study_dose"}
    common = ["--device", "cuda", "--seed", str(seed)]
    res = dict(tree=str(root), build_s=round(build_s, 3))
    with tempfile.TemporaryDirectory(prefix="ipdm_abl_ab_") as out:
        warm = list(argv)
        warm[warm.index("--study") + 1] = "hu-drift"
        abl.main(["--out", os.path.join(out, "warm"), *common, *warm])
        torch.cuda.synchronize()
        funcs = {n: getattr(abl, f) for n, f in studies.items()}
        for n, f in studies.items():
            setattr(abl, f, timed(n, funcs[n]))
        unet.flash_attention = counted
        for n in bwd:
            setattr(attention, n, bwd_counted(n))
        _build.reset_launches()
        t0 = time.perf_counter()
        abl.main(["--out", os.path.join(out, "timed"), *common, *argv])
        torch.cuda.synchronize()
        res["main_s"] = round(time.perf_counter() - t0, 3)
        unet.flash_attention = flash
        for n, f in bwd.items():
            setattr(attention, n, f)
        for n, f in studies.items():
            setattr(abl, f, funcs[n])
        res.update(study_s=per, flash_calls=dict(calls),
                   bwd_calls=dict(bwd_calls), launches={
                       k: v for k, v in _build.LAUNCHES.items() if v})
        if profile:
            t0 = time.perf_counter()
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                abl.main(["--out", os.path.join(out, "prof"), *common,
                          *argv])
                torch.cuda.synchronize()
            res["profiled_main_s"] = round(time.perf_counter() - t0, 3)
            kern, total = {}, 0.0
            for e in prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA:
                    continue
                ms = e.duration_ns() / 1e6
                total += ms
                if "flash" in e.name() or "split" in e.name():
                    n, t = kern.get(e.name()[:120], (0, 0.0))
                    kern[e.name()[:120]] = (n + 1, t + ms)
            res["device_ms_total"] = round(total, 3)
            res["device_ms"] = {k: [n, round(t, 3)]
                                for k, (n, t) in kern.items()}
            res["bwd_hd8_ms"] = round(sum(
                t for k, (n, t) in kern.items() if is_bwd_hd8(k)), 3)
    return res


def is_bwd_hd8(kernel: str) -> bool:
    """Whether a profiled kernel name is one the f32 flash backward at
    head dim 8 launches: the D kernel, then the template's head-dim-8
    instance (a tree without csrc/flash_narrow_bwd.cu, with its split
    staged in the CTA) or the narrow body and its pre-pass. The run's
    other flash backward calls are none: the ablation UNets' attention
    runs at head dim 8 alone."""
    return ("flash_bwd_dot_kernel" in kernel
            or ("flash_bwd_kernel" in kernel and ", 8>" in kernel)
            or "narrow_bwd" in kernel)


def run_child(root: Path, seed: int, argv: list, profile: bool,
              timeout: float) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           str(root), "--seed", str(seed), "--argv", json.dumps(argv)]
    if profile:
        cmd.append("--profile")
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode:
        raise RuntimeError(f"{root}: rc {p.returncode}\n{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a run may take")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--argv", help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child is not None:
        print(json.dumps(child(a.child, a.seed, json.loads(a.argv),
                               a.profile)))
        return 0
    if a.parent is None:
        ap.error("--parent DIR is required")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("ablations_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    cs.log(f"ablations-ab: {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{smi}; main({' '.join(cs.ABLATION_ARGV)})")
    trees = {"parent": a.parent.resolve(), "new": ROOT}
    runs, seen = [], set()
    for side in ("parent", "new", "new", "parent"):
        r = run_child(trees[side], a.seed, cs.ABLATION_ARGV,
                      side not in seen, a.timeout)
        seen.add(side)
        r["side"] = side
        runs.append(r)
        cs.log(f"ablations-ab: {side}: main {r['main_s']} s; studies "
               f"{r['study_s']}; flash calls {r['flash_calls']}; backward "
               f"launches {r['bwd_calls']}"
               + (f"; profiled main {r['profiled_main_s']} s, device "
                  f"{r['device_ms_total']} ms, the hd-8 backward's "
                  f"{r['bwd_hd8_ms']} ms, by kernel {r['device_ms']}"
                  if "device_ms" in r else ""))
    line = json.dumps({"device": smi, "runs": runs})
    if a.out:
        os.makedirs(a.out.parent, exist_ok=True)
        a.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Registers, stack and spills of each kernel the port builds, as
``nvcc -Xptxas -v`` reports them for sm_90a (on a machine with the CUDA
toolkit).

    python3 scripts/ptxas_report.py [flash_attn.cu flash_bwd.cu ...]

Compiles each named source of ``ipdm_tpu_torch/csrc`` (default: all) with
the build's own flags (``ops/cuda/_build.py`` NVCC_FLAGS), one nvcc per
source, all at once, into a scratch directory, and prints one line per
kernel: its demangled name, registers a thread, stack frame, spill
stores and loads (bytes)."""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    from ipdm_tpu_torch.ops.cuda import _build

    names = sys.argv[1:] or [p.name for p in sorted(_build.SRC_DIR.glob("*.cu"))]
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(n, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.SRC_DIR), "-c", str(_build.SRC_DIR / n), "-o",
             str(Path(tmp) / (n + ".o"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for n in names]
        outs = [(n, p.communicate()[0], p.returncode) for n, p in procs]
    rc = 0
    for name, out, code in outs:
        if code:
            print(f"{name}: nvcc failed\n{out}")
            rc = 1
            continue
        fn, frame = None, {}
        for line in out.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and fn:
                frame[fn] = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                pretty = subprocess.run(["c++filt", fn], capture_output=True,
                                        text=True).stdout.strip() or fn
                st, ss, sl = frame.get(fn, ("?", "?", "?"))
                print(f"{name}: {pretty[:150]}: {m.group(1)} registers, "
                      f"stack {st} B, spill stores {ss} B, loads {sl} B")
    return rc


if __name__ == "__main__":
    sys.exit(main())

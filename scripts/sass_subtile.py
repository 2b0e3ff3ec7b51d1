#!/usr/bin/env python3
"""Instructions a 64-row sub-tile issues in the key loop of the narrow
flash backward (head dim 8, f32), from the SASS that the build's nvcc
makes for sm_90a (on a machine with the CUDA toolkit).

    python3 scripts/sass_subtile.py [flash_narrow_bwd.cu ...]

Compiles each named source of ``ipdm_tpu_torch/csrc`` (default:
flash_narrow_bwd.cu, whose sub-tile is 64 x 64 scores) to a cubin with
the build's own flags (``ops/cuda/_build.py`` NVCC_FLAGS), disassembles
it with ``cuobjdump -sass`` and, for each kernel whose key loop holds
m64n64k16 ``HGMMA``s (the score products), counts the instructions from
the warpgroup arrive before the first score product to the next
sub-tile's first score product, leaving out the blocks that a forward
branch skips and that hold ``FSEL`` (the mask of the last tile, which
runs once a row). Prints one line per kernel: the count, the count per
score (a thread's 32 scores a sub-tile), and the count by opcode. On an
H100 the narrow backward's time follows that count (PERF.md rows 3q8 /
3k8).
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SCORES = 32  # scores a thread holds in a 64 x 64 sub-tile (m64n64 sums)


def functions(sass: str) -> dict:
    """{kernel name: [(address, instruction text)]} of cuobjdump -sass."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,6})\*/\s+(.*?);", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def subtile(body: list):
    """The instructions of one sub-tile of the key loop (see the module's
    note), or None where the kernel has no m64n64 score products."""
    score = [i for i, (_, t) in enumerate(body) if "HGMMA.64x64x16" in t]
    if not score:
        return None
    first = score[0]
    start = max((i for i in range(first)
                 if "WARPGROUP.ARRIVE" in body[i][1]), default=first)
    # the next sub-tile's first score product: the first one with a
    # product (an HGMMA of another shape) between it and the first
    end = next((i for i in score[1:] if any(
        "HGMMA" in body[j][1] and "64x64x16" not in body[j][1]
        for j in range(first, i))), len(body))
    seg, out, skip = body[start:end], [], None
    for addr, text in seg:
        if skip is not None and addr < skip:
            continue
        skip = None
        out.append(text)
        m = re.match(r"@!?P\d BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) > addr:
            target = int(m.group(1), 16)
            if any("FSEL" in t for a, t in seg if addr < a < target):
                skip = target
    return out


def main() -> int:
    from ipdm_tpu_torch.ops.cuda import _build

    names = sys.argv[1:] or ["flash_narrow_bwd.cu"]
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            cubin = Path(tmp) / (Path(name).stem + ".cubin")
            subprocess.run([nvcc, *flags, "-I", str(_build.SRC_DIR),
                            "-cubin", "-o", str(cubin),
                            str(_build.SRC_DIR / name)], check=True)
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                  check=True, capture_output=True,
                                  text=True).stdout
            for kernel, body in functions(sass).items():
                ins = subtile(body)
                if ins is None:
                    continue
                ops = collections.Counter(
                    re.sub(r"^@!?U?P\w+ ", "", t).split(" ")[0].split(".")[0]
                    for t in ins)
                print(f"{name}: {kernel[:90]}: {len(ins)} instructions a "
                      f"sub-tile, {len(ins) / SCORES:.2f} a score; "
                      + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

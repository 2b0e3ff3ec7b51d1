"""Build and load the port's CUDA kernels (``ipdm_tpu_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use into ``ipdm_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged
one is loaded as it is.

Every C entry point takes its pointers and the CUDA stream as
``void*``, launches on that stream, and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception. Each kernel
wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

P, I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point: argtypes (pointers and the stream as
# c_void_p, sizes and flags as c_int); each returns a cudaError_t as int.
SIGNATURES = {
    # x, a, bb, w, bias, skip, out, B, C, O, H, W, act, bf16, stream
    "planar_unit_launch": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    # Q, s0, s1, frac, out, V, B, L, n, stream
    "bp_shift_launch": [P, P, P, P, P, I, I, I, I, P],
    # the flash kernels take the head dimension hd (FLASH_HEAD_DIMS: a
    # template instance each) after T
    # q, k, v, out, lse (or null), BH, T, hd, scale_log2, stream
    "flash_attn_launch": [P, P, P, P, P, I, I, I, ctypes.c_float, P],
    # q, k, v, split (scratch), out, lse (or null), BH, T, hd, scale_log2,
    # stream
    "flash_attn_f32_launch": [P, P, P, P, P, P, I, I, I, ctypes.c_float, P],
    # q, k, v, out, do, lse, D, dq, split (scratch of f32 at hd 128, or
    # null), BH, T, hd, scale_log2, scale2, bf16, stream
    "flash_bwd_dq_launch": [P, P, P, P, P, P, P, P, P, I, I, I,
                            ctypes.c_float, ctypes.c_float, I, P],
    # q, k, v, do, lse, D, dk, dv, split (as dq's), BH, T, hd, scale_log2,
    # scale2, bf16, stream
    "flash_bwd_dkv_launch": [P, P, P, P, P, P, P, P, P, I, I, I,
                             ctypes.c_float, ctypes.c_float, I, P],
    # rows, s0, s1, w0, w1, out, V, B, W, L, n, stream
    "fp_deposit_launch": [P, P, P, P, P, P, I, I, I, I, I, P],
    # x, rf, inv2, frac, s0, rows, nrmi, T, S, Vp, B, n, L, tile, lam,
    # bf16, stream
    "os_sart_sweep_launch": [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                             ctypes.c_float, I, P],
    # P, qi0, W, out, V, B, Ntp, Lp, Wt, stream
    "anterp_taps_launch": [P, P, P, P, I, I, I, I, I, P],
    # Q2, s0, s1, frac, out, V, L, n, stream
    "bp_shift_single_launch": [P, P, P, P, P, I, I, I, P],
}

# the head dimensions the flash kernels are instantiated for: the UNets the
# repo ships reach 64 (the presets' and FULL_ARCH's), 8 (the ablation
# UNets' middle block) and 16 (the flagship-small UNet); 128 is the head
# dim of the presets at model_channels 128. Every other head dim up to 128
# runs on the next instance up, zero-padded (ops/cuda/attention.py
# flash_instance; tests/test_torch_flash_head_dims.py walks the UNets).
# csrc/hopper.cuh IPDM_FLASH_HEAD_DIMS lists the same set for the entry
# points' switches
FLASH_HEAD_DIMS = (8, 16, 32, 64, 128)


def flash_counter(name: str, hd: int) -> str:
    """The :data:`LAUNCHES` key of flash kernel ``name`` at head dimension
    ``hd``."""
    return name if hd == 64 else f"{name}_hd{hd}"


# launches per kernel since the last reset_launches(); each wrapper adds
# one where it launches its kernel and nowhere else. The flash kernels
# count head dimension 64 under their own name and each other head
# dimension's instance under "<name>_hd<hd>" (flash_counter)
FLASH_KERNELS = ("flash_attn", "flash_attn_f32", "flash_bwd_dq",
                 "flash_bwd_dkv")
LAUNCHES = {"planar_unit": 0, "bp_shift": 0, "flash_attn": 0,
            "fp_plane_deposit": 0, "os_sart_sweep": 0, "anterp_taps": 0,
            "os_sart_sweep_bf16": 0, "bp_shift_accumulate": 0,
            "fp_shift_deposit_batched": 0, "fp_shift_deposit": 0,
            "flash_attn_f32": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            **{flash_counter(k, hd): 0 for k in FLASH_KERNELS
               for hd in FLASH_HEAD_DIMS}}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _compile(out_dir: Path) -> Path:
    nvcc = _nvcc()
    cus = sorted(SRC_DIR.glob("*.cu"))
    procs = []
    for src in cus:  # one nvcc per source, all running at once
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    lib = out_dir / "libipdm_kernels.so"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
           *[str(o) for _s, o, _p in procs]]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode:
        raise RuntimeError("nvcc link failed\n"
                           + res.stdout.decode(errors="replace"))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        final = BUILD_DIR / _digest()
        lib_path = final / "libipdm_kernels.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
            try:
                _compile(tmp)
                try:
                    tmp.rename(final)   # atomic publish of a whole build
                except OSError:
                    if not lib_path.exists():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {code}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

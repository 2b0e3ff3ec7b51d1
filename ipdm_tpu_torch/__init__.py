"""PyTorch/CUDA port of ipdm_tpu: IPDM low-dose CT denoising on an NVIDIA H100.

The package mirrors the layout of ``ipdm_tpu`` module by module. Plain
tensor code is PyTorch; every Pallas kernel of the JAX package on the
ported path is a CUDA C++ kernel under ``csrc/``, built at first use
(``ops/cuda/_build.py``).

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without that argument they raise.
Kernel wrappers use their plain PyTorch version only for tensors on the
CPU; for a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is None.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present; the port never carries on on the CPU
    unless told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ipdm_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev

"""The port stands alone: importing ipdm_tpu_torch and every submodule
loads neither JAX nor the JAX package, and its entry points run on CUDA
unless the caller passes device="cpu"."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import ipdm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ipdm_tpu_torch.__path__,
                                                "ipdm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "ipdm_tpu"))}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("ipdm_tpu_torch.models.unet",
                 "ipdm_tpu_torch.engine.denoiser",
                 "ipdm_tpu_torch.recon.fbp_fast",
                 "ipdm_tpu_torch.ops.cuda.shift",
                 "ipdm_tpu_torch.utils.torch_import"):
        assert name in out["modules"]
    assert out["loaded"] == []


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA device and no device="cpu", the entry points raise
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
    from ipdm_tpu_torch.engine.denoiser import progressive_denoiser
    from ipdm_tpu_torch.models.unet import UNetModel
    with pytest.raises(RuntimeError, match="CUDA"):
        UNetModel(model_channels=8, channel_mult=(1, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        GaussianDiffusion(10, "cosine")
    opt = dict(convertor="FBP", timesteps_proj=10, schedule_power_proj=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        progressive_denoiser(opt, None, None, torch.zeros(1, 8, 8, 1), None)

"""The port stands alone: importing ipdm_tpu_torch and every submodule,
its entry script main_torch.py, its examples, chip_smoke.py and
scripts/multihost_dryrun_torch.py loads
neither JAX nor the JAX package, and its entry points run on CUDA unless
the caller passes device="cpu"."""

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
import runpy
scripts = ("main_torch.py", "examples/synthetic_e2e_torch.py",
           "examples/bench_train_torch.py", "chip_smoke.py",
           "examples/ablations_torch.py", "__graft_entry_torch__.py",
           "scripts/multihost_dryrun_torch.py")
for script in scripts:
    runpy.run_path(script, run_name="imported")  # its imports, not its main
names += list(scripts)
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
                 "ipdm_tpu_torch.utils.torch_import",
                 "ipdm_tpu_torch.config.config",
                 "ipdm_tpu_torch.metrics.fsim",
                 "ipdm_tpu_torch.data.dataset",
                 "ipdm_tpu_torch.recon.simulate",
                 "ipdm_tpu_torch.engine.checkpoint",
                 "ipdm_tpu_torch.engine.trainer",
                 "ipdm_tpu_torch.data.sampler",
                 "ipdm_tpu_torch.utils.native",
                 "ipdm_tpu_torch.parallel.mesh",
                 "ipdm_tpu_torch.data.dicom",
                 "main_torch.py", "examples/synthetic_e2e_torch.py",
                 "examples/bench_train_torch.py", "chip_smoke.py",
                 "examples/ablations_torch.py", "__graft_entry_torch__.py",
                 "scripts/multihost_dryrun_torch.py"):
        assert name in out["modules"]
    assert out["loaded"] == []


@pytest.mark.parametrize("path", ["main_torch.py",
                                  "examples/synthetic_e2e_torch.py",
                                  "examples/bench_train_torch.py",
                                  "chip_smoke.py",
                                  "examples/ablations_torch.py",
                                  "__graft_entry_torch__.py"])
def test_scripts_name_no_jax_module(path):
    """No import statement of the port's scripts names jax or the JAX
    package, wherever in the file it stands (function-level ones too)."""
    import ast
    tree = ast.parse((ROOT / path).read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert mods
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "ipdm_tpu")]
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
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
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
    with pytest.raises(RuntimeError, match="CUDA"):
        ProgressiveDomainDenoiser(IPDMConfig(mode="test_prog"))
    import __graft_entry_torch__ as graft
    with pytest.raises(RuntimeError, match="CUDA"):
        graft.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft.dryrun_multichip(2)
    from examples import ablations_torch
    with pytest.raises(RuntimeError, match="CUDA"):
        ablations_torch.main(["--out", str(tmp_path), "--study", "nfe"])

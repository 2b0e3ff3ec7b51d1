"""Checkpoint save/load of model weights and optimizer state (port of
ipdm_tpu/engine/checkpoint.py ``CheckpointManager``).

One file per module under the reference's ``save_models/{name}-{epoch}``
layout (Utils/loggerx.py:62-80): a ``state_dict`` written with
``torch.save`` and read with ``torch.load(weights_only=True)``, so resume
semantics (``resume_epochs_{img,proj}`` → checkpoint id) carry over. A
file written by the original PyTorch repo (its ``DataParallel`` keys carry
a ``module.`` prefix) loads through ``strip_module_prefix``. The
optimizer's file (``optimizer-{epoch}``) is its ``state_dict``, as the
reference saves it, so Adam's moments and step survive a restart.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Optional

import torch

from ipdm_tpu_torch.utils.torch_import import strip_module_prefix


class CheckpointManager:
    """``save_models/{name}-{epoch}`` files of model ``state_dict``s; the
    directory is made at the first save."""

    def __init__(self, models_save_dir: str):
        self.dir = models_save_dir

    def save(self, name: str, epoch: int, model: torch.nn.Module) -> str:
        """Write the module's weights (on the CPU, so the file loads on any
        machine); returns the path."""
        os.makedirs(self.dir, exist_ok=True)
        path = osp.join(self.dir, f"{name}-{epoch}")
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save(state, path)
        return path

    def save_optimizer(self, name: str, epoch: int,
                       optimizer: torch.optim.Optimizer) -> str:
        """Write the optimizer's ``state_dict`` (its tensors on the CPU);
        returns the path."""
        os.makedirs(self.dir, exist_ok=True)
        path = osp.join(self.dir, f"{name}-{epoch}")
        state = optimizer.state_dict()
        state["state"] = {i: {k: v.detach().cpu() if torch.is_tensor(v)
                              else v for k, v in s.items()}
                          for i, s in state["state"].items()}
        torch.save(state, path)
        return path

    def load_optimizer(self, name: str, epoch: int,
                       optimizer: torch.optim.Optimizer,
                       load_dir: Optional[str] = None) -> bool:
        """Load ``{name}-{epoch}`` into ``optimizer`` (its state moves to
        the parameters' device). Returns False when there is no such
        file."""
        path = osp.join(load_dir or self.dir, f"{name}-{epoch}")
        if not osp.exists(path):
            return False
        optimizer.load_state_dict(torch.load(path, map_location="cpu",
                                             weights_only=True))
        return True

    def load(self, name: str, epoch: int, model: torch.nn.Module,
             load_dir: Optional[str] = None) -> bool:
        """Load ``{name}-{epoch}`` from ``load_dir`` (default: this
        manager's directory) into ``model``, strictly: a missing or extra
        key raises. Returns False when there is no such file."""
        path = osp.join(load_dir or self.dir, f"{name}-{epoch}")
        if not osp.exists(path):
            return False
        state: Dict[str, torch.Tensor] = strip_module_prefix(
            torch.load(path, map_location="cpu", weights_only=True))
        model.load_state_dict(state, strict=True)
        return True

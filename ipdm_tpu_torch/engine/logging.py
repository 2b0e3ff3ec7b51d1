"""Run logging: stdout metric lines and option snapshots (port of
ipdm_tpu/engine/logging.py ``LoggerX``).

Equivalent of the reference LoggerX (Utils/loggerx.py:25-120) minus the
stack-inspection variable-name magic (callers pass names explicitly). The
scalar stream of the training loop (``ScalarWriter``) is ported with
training.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict


class LoggerX:
    def __init__(self, save_root: str, opt=None, rank: int = 0):
        self.models_save_dir = osp.join(save_root, "save_models")
        os.makedirs(self.models_save_dir, exist_ok=True)
        self.rank = rank
        self.save_root = save_root

    def save_option(self, opt) -> None:
        """Dump the full config (loggerx.py:82-86)."""
        d = opt.to_dict() if hasattr(opt, "to_dict") else dict(opt.__dict__)
        with open(osp.join(self.models_save_dir, "option.json"), "w") as f:
            json.dump(d, f, sort_keys=False, indent=4, separators=(",", ": "))

    def msg(self, stats: Dict[str, float], step: int) -> None:
        """Stdout metric line (loggerx.py:90-108); rank-0 only."""
        if self.rank != 0:
            return
        out = "[{}] {:05d}, ".format(
            time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()), step)
        for name, var in stats.items():
            out += "{} {:2.5f}, ".format(name, float(var))
        print(out)

"""Run logging: stdout metric lines, the JSONL scalar stream, option
snapshots (port of ipdm_tpu/engine/logging.py).

Equivalent of the reference LoggerX (Utils/loggerx.py:25-120) minus the
stack-inspection variable-name magic (callers pass names explicitly), and
the training loop's ``ScalarWriter``: a JSONL scalar stream in the JAX
package's format with a TensorBoard twin (the reference's SummaryWriter,
train_test_utils.py:138,339).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict


class ScalarWriter:
    """``scalars.jsonl`` (one ``{"tag", "value", "step", "time"}`` object a
    line) plus a TensorBoard event file in the same directory."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(osp.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:   # TensorBoard not installed: the JSONL only
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(global_step),
                                  "time": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step)

    def add_scalars(self, tag: str, values: Dict[str, float],
                    global_step: int) -> None:
        for k, v in values.items():
            self.add_scalar(f"{tag}/{k}", v, global_step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class LoggerX:
    """The run's option snapshot and stdout lines; a rank other than 0
    writes and prints nothing."""

    def __init__(self, save_root: str, opt=None, rank: int = 0):
        self.models_save_dir = osp.join(save_root, "save_models")
        self.rank = rank
        if rank == 0:
            os.makedirs(self.models_save_dir, exist_ok=True)
        self.save_root = save_root

    def save_option(self, opt) -> None:
        """Dump the full config (loggerx.py:82-86); rank-0 only."""
        if self.rank != 0:
            return
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

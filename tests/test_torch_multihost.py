"""scripts/multihost_dryrun_torch.py, the twin of
scripts/multihost_dryrun.py: two processes that meet the way torchrun's
do (``env://``) and join through the engine's ``_join_mesh``, on the
CPU; and its data-parallel check (check 3) beside a planted fault, run
on two gloo ranks through ``parallel/spawn.run_ranks``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import torch_mesh_ranks as R
from ipdm_tpu_torch.parallel.spawn import run_ranks

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120   # s for a 2-rank spawn: start-up and one step


def test_twin_passes_on_two_cpu_processes():
    """The launcher starts two children with torchrun's variables; both
    pass every check and its last line says so."""
    res = subprocess.run(
        [sys.executable, "scripts/multihost_dryrun_torch.py", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "processes": 2, "returncodes": [0, 0]}
    for check in ("wiring ok", "sampler shards ok", "dp step ok",
                  "rank-0 gating ok (rank 0: printed=True",
                  "rank-0 gating ok (rank 1: printed=False"):
        assert check in res.stderr, check


@pytest.mark.parametrize("perturb", [0.0, 0.5], ids=["held", "perturbed"])
def test_dp_check_sees_a_rank_with_a_wrong_batch(tmp_path, perturb):
    """Check 3 passes on the right halves and fails with rank 1's half of
    the batch moved by 0.5: the loss and the parameters still agree
    across the ranks (DDP averages the gradients, the loss is
    all-reduced), so the comparison with the one-process step on the
    whole batch is what sees it."""
    if perturb == 0.0:
        losses = run_ranks(R.dryrun_step, 2, tmp_path, (perturb,),
                           timeout=RANK_TIMEOUT, threads=1)
        assert losses[0] == losses[1]
        return
    with pytest.raises(RuntimeError, match="one-process step"):
        run_ranks(R.dryrun_step, 2, tmp_path, (perturb,),
                  timeout=RANK_TIMEOUT, threads=1)

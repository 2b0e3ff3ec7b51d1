"""Run a function on n spawned ranks of one gloo process group on this
machine: the launcher of the mesh's multi-process checks (the tests'
2-rank groups on the CPU, and two ranks sharing one card, where NCCL
refuses two ranks on one device). The ranks meet through a
``FileStore`` in a scratch directory, not a TCP port, so several groups
can run side by side, and gloo connects them over the loopback
interface (``GLOO_SOCKET_IFNAME``, unless the caller set it): all ranks
are on this machine, whatever its hostname resolves to."""

from __future__ import annotations

import datetime
import os
import os.path as osp
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def run_ranks(fn: Callable, n: int, tmp, args: Sequence = (),
              timeout: float = 300.0, threads: Optional[int] = None) -> list:
    """Run ``fn(rank, tmp, *args)`` on n spawned ranks of one gloo group
    and return each rank's result (``torch.save``-able), in rank order.

    ``fn`` must be importable by the children (a module-level function).
    ``tmp`` is an existing directory that holds the store, each rank's
    result (rank{r}.pt) and, where a rank raises, its traceback
    (rank{r}.err). ``threads`` sets each rank's intra-op threads. A rank
    that raises, exits non-zero, or is still running ``timeout`` seconds
    after the start (then every rank is killed) fails the call with the
    ranks' tracebacks."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = str(tmp)
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, n, tmp, args, threads, timeout))
             for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, timeout - (time.perf_counter() - t0)))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = []
    for r in range(n):
        err = osp.join(tmp, f"rank{r}.err")
        if osp.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if alive or errors or any(p.exitcode for p in procs):
        raise RuntimeError(
            f"ranks still running after {timeout} s: {alive}; exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(osp.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def _entry(fn, rank, n, tmp, args, threads, timeout):
    if threads is not None:
        torch.set_num_threads(threads)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(osp.join(tmp, "store"), n)
    # a collective that waits longer than the run may take raises
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        # every rank's connections are up before any rank can finish and
        # close its own: gloo's init on a slower rank fails when a peer
        # that returned from init has already closed the group
        dist.barrier()
        out = fn(rank, tmp, *args)
        torch.save(out, osp.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(osp.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()

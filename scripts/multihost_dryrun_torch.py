"""Two-process dryrun of the port's multi-process plumbing: the twin of
scripts/multihost_dryrun.py for ``ipdm_tpu_torch``.

Launcher mode (no MH_RANK in the environment): picks a free port, starts
two copies of this script with the variables torchrun sets (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; and MH_RANK), waits,
prints each child's lines on stderr and, as its last line, one JSON
object ``{"ok": ..., "processes": 2, "returncodes": [...]}``.

Child mode joins the process group through the engine's own
``_join_mesh`` (engine/denoiser.py), the branch a torchrun launch takes:

* on the CPU (``--device cpu``) ``_join_mesh`` initialises gloo from the
  environment itself;
* on the card (the default, ``cuda``: it raises without CUDA) both ranks
  share ``cuda:0``, where NCCL refuses two ranks on one device, so the
  child initialises gloo from the environment first and ``_join_mesh``
  takes the group as it is.

Then the checks of scripts/multihost_dryrun.py:83-191:

1. wiring: world size 2, each rank its own index, a [2, 1] mesh;
2. ``RandomSampler`` rank shards: disjoint, and together they cover each
   12-index block;
3. one ``make_sharded_train_step`` step of the small ε-model (three 3×3
   convs of width 8 on x concatenated with a t/100 channel) on the global
   batch [4, 8, 8, 1] of ``default_rng(0)``, each rank holding its half:
   the loss is finite and bit-equal on both ranks, every parameter is
   bit-equal after the step, and the loss and the averaged gradients
   agree with the one-process step (``make_train_step``) on the whole
   batch with the same t and noise (the cross-rank equalities hold
   whatever the ranks hold: DDP averages the gradients and the loss is
   all-reduced, so this comparison is what sees a rank's wrong batch);
4. rank-0 gating, as the engine gates it: rank 1 runs the gated save
   and log calls first and writes nothing; then rank 0 saves the model
   with ``CheckpointManager`` (the engine saves on rank 0 alone,
   engine/denoiser.py; the JAX package's save is a collective Orbax
   call); after a barrier both ranks load the file and compare it with
   their own parameters; ``LoggerX(rank=...)`` prints on rank 0 only.

    python scripts/multihost_dryrun_torch.py --device cpu   # CPU, ~15 s
    python scripts/multihost_dryrun_torch.py                # one card
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TIMEOUT = 600   # s for both children
# check 3's agreement with the one-process step, per tensor: the sums of
# the averaged gradients run in another order (f32)
STEP_TOL = 1e-5


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launcher(device: str) -> int:
    port = _free_port()
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", device],
        env=dict(env, MH_RANK=str(r), RANK=str(r), LOCAL_RANK=str(r)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        outs = [f"killed after {TIMEOUT} s"] * 2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(p.returncode == 0 for p in procs)
    for rank, out in enumerate(outs):
        for line in out.strip().splitlines():
            print(f"[rank {rank}] {line}", file=sys.stderr)
    print(json.dumps({"ok": ok, "processes": 2,
                      "returncodes": [p.returncode for p in procs]}))
    return 0 if ok else 1


def _net():
    """The ε-model of scripts/multihost_dryrun.py:120-127, NCHW: three
    3×3 convs of width 8 (SiLU between) on x and a t/100 channel."""
    import torch
    from torch import nn

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2d(2, 8, 3, padding=1)
            self.c2 = nn.Conv2d(8, 8, 3, padding=1)
            self.c3 = nn.Conv2d(8, 1, 3, padding=1)

        def forward(self, x, t):
            temb = (t.float() / 100.0).view(-1, 1, 1, 1).expand_as(x)
            h = nn.functional.silu(self.c1(torch.cat([x, temb], 1)))
            h = nn.functional.silu(self.c2(h))
            return self.c3(h)

    return Net()


def _gather(x, world: int) -> list:
    """x (any device) from every rank, on the CPU: gloo gathers CPU
    tensors only."""
    import torch
    import torch.distributed as dist

    x = x.detach().reshape(-1).cpu()
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x)
    return out


def dp_step_check(rank: int, mesh, dev, perturb: float = 0.0) -> dict:
    """Check 3 on a 2-rank data mesh: the sharded step against itself on
    the other rank and against the one-process step on the whole batch.
    ``perturb`` is added to this rank's half of the batch (a planted
    fault: the check must fail). Raises AssertionError on a miss;
    returns the loss, the one-process loss, the largest miss (a share of
    max|grad|, or of the loss) and the model after the step."""
    import numpy as np
    import torch
    from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
    from ipdm_tpu_torch.engine.trainer import make_optimizer, make_train_step
    from ipdm_tpu_torch.parallel.mesh import make_sharded_train_step

    world = mesh.size()
    torch.manual_seed(0)
    model = _net().to(dev)
    ref = copy.deepcopy(model)
    gd = GaussianDiffusion(timesteps=50, beta_schedule="cosine", device=dev)
    full = np.random.default_rng(0).random((4, 8, 8, 1), np.float32)
    rows = slice(rank * 2, rank * 2 + 2)
    held = np.zeros_like(full)          # this rank holds its half alone
    held[rows] = full[rows] + perturb
    noise_rng = np.random.default_rng(1)
    t = noise_rng.integers(0, 10, 4)
    noise = noise_rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    step = make_sharded_train_step(model, gd, make_optimizer(
        model.parameters(), 1e-3), 10, mesh, None)
    loss = step(held, t, noise)
    ref_loss = make_train_step(ref, gd, make_optimizer(ref.parameters(),
                                                       1e-3), 10, None)(
        full, t, noise)
    lf = float(loss)
    assert np.isfinite(lf), lf
    losses = _gather(loss, world)
    assert all(torch.equal(x, losses[0]) for x in losses), losses
    for p in model.parameters():
        got = _gather(p, world)
        assert all(torch.equal(x, got[0]) for x in got), "params differ"
    worst = abs(lf - float(ref_loss)) / abs(float(ref_loss))
    for p, q in zip(model.parameters(), ref.parameters()):
        scale = float(q.grad.abs().max())
        worst = max(worst, float((p.grad - q.grad).abs().max()) / scale)
    assert worst <= STEP_TOL, (
        f"the sharded step misses the one-process step on the whole batch: "
        f"{worst:.3e} of max|grad| (limit {STEP_TOL:g})")
    return dict(loss=lf, ref_loss=float(ref_loss), worst=worst,
                model=model)


def _sampler_check() -> None:
    from ipdm_tpu_torch.data.sampler import RandomSampler

    def idxs(r):
        return list(RandomSampler(dataset_len=12, batch_size=2, num_iter=6,
                                  seed=3, num_replicas=2, rank=r))
    a, b = idxs(0), idxs(1)
    assert len(a) == len(b) == 12
    interleaved = [v for pair in zip(a, b) for v in pair]
    for blk in range(0, len(interleaved), 12):
        block = interleaved[blk:blk + 12]
        assert sorted(block) == list(range(12)), block


def _gating_check(rank: int, model, d: str) -> bool:
    """Check 4 in ``d`` (shared by both ranks): rank 1's gated calls
    first (nothing written), then rank 0's; both load the saved model.
    Returns whether this rank printed its log line."""
    import torch
    import torch.distributed as dist
    from ipdm_tpu_torch.engine.checkpoint import CheckpointManager
    from ipdm_tpu_torch.engine.logging import LoggerX

    def gated():
        lg = LoggerX(d, rank=rank)
        if rank == 0:          # the engine's gate (engine/denoiser.py)
            CheckpointManager(lg.models_save_dir).save("img_model", 0, model)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lg.msg({"loss": 1.0}, 0)
        return bool(buf.getvalue())

    def files():
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    printed = None
    if rank == 1:
        printed = gated()
        assert files() == [], f"rank 1 wrote {files()}"
    dist.barrier()
    if rank == 0:
        printed = gated()
    dist.barrier()
    want = [os.path.join("save_models", "img_model-0")]
    assert files() == want, files()
    back = _net()
    CheckpointManager(os.path.join(d, "save_models")).load("img_model", 0,
                                                            back)
    for (name, a), b in zip(back.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b.cpu()), name
    assert printed == (rank == 0), (rank, printed)
    return printed


def child(device: str) -> int:
    rank = int(os.environ["MH_RANK"])
    import torch
    import torch.distributed as dist
    from ipdm_tpu_torch import resolve_device
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import _join_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        # NCCL refuses two ranks on one device: gloo, initialised here
        # from torchrun's variables, and _join_mesh takes it as it is
        dist.init_process_group("gloo")
        device = "cuda:0"
    opt = IPDMConfig(mode="train_img", mesh_shape=[2, 1], device=device,
                     batch_size=2)
    mesh, dev = _join_mesh(opt)

    # 1. wiring
    assert dist.get_world_size() == 2, dist.get_world_size()
    assert dist.get_rank() == rank, (dist.get_rank(), rank)
    assert tuple(mesh.shape) == (2, 1), mesh.shape
    print(f"wiring ok: rank {rank} of {dist.get_world_size()}, mesh "
          f"{tuple(mesh.shape)}, {dist.get_backend()} on {dev}")

    # 2. sampler shards
    _sampler_check()
    print("sampler shards ok: disjoint per position, covering per block")

    # 3. the data-parallel step
    res = dp_step_check(rank, mesh, dev)
    print(f"dp step ok: loss {res['loss']:.6f} bit-equal on both ranks, "
          f"params bit-equal; against the one-process step "
          f"{res['worst']:.2e} of max|grad| (loss {res['ref_loss']:.6f})")

    # 4. rank-0 gating
    root = os.path.join(tempfile.gettempdir(),
                        f"mh_torch_{os.environ['MASTER_PORT']}")
    printed = _gating_check(rank, res["model"], root)
    print(f"rank-0 gating ok (rank {rank}: printed={printed}; one "
          f"checkpoint file, loaded back equal on both ranks)")
    dist.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (both ranks on cuda:0) or cpu")
    args = ap.parse_args()
    if "MH_RANK" in os.environ:
        return child(args.device)
    return launcher(args.device)


if __name__ == "__main__":
    sys.exit(main())

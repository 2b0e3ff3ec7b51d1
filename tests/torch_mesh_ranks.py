"""The rank side of tests/test_torch_parallel.py: each function runs in a
spawned process of a 2-rank gloo group (``parallel/spawn.py``
``run_ranks``, its FileStore in the test's tmp_path) and imports torch
and the port only; the parent runs JAX and the single-process
references."""

from __future__ import annotations

import os
import os.path as osp
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist


def failing_rank(rank, tmp):
    """Rank 1 raises: run_ranks must fail with its traceback."""
    if rank == 1:
        raise ValueError("a planted fault on rank 1")
    return rank


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


class ConvNet(torch.nn.Module):
    """tests/test_parallel.py's pure-conv ε-model: [x, t/100] → 3×3 conv
    (8) → SiLU → 3×3 conv (8) → SiLU → 3×3 conv (C)."""

    def __init__(self, channels: int = 1):
        super().__init__()
        self.c1 = torch.nn.Conv2d(channels + 1, 8, 3, padding=1)
        self.c2 = torch.nn.Conv2d(8, 8, 3, padding=1)
        self.c3 = torch.nn.Conv2d(8, channels, 3, padding=1)

    def forward(self, x, t):
        temb = (t.float() / 100.0)[:, None, None, None].expand_as(x)
        h = torch.nn.functional.silu(self.c1(torch.cat([x, temb], 1)))
        return self.c3(torch.nn.functional.silu(self.c2(h)))


def train_model(name: str, cfg: dict):
    """The step check's model, seeded alike in every process."""
    from ipdm_tpu_torch.models.unet import UNetModel
    torch.manual_seed(0)
    return ConvNet() if name == "convnet" else UNetModel(**cfg,
                                                         device="cpu")


def mesh_checks(rank, tmp, inp):
    """Every mesh function on this rank's share of the parent's inputs."""
    from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
    from ipdm_tpu_torch.engine.trainer import make_optimizer
    from ipdm_tpu_torch.models.unet import GroupNorm, UNetModel, conv_unit
    from ipdm_tpu_torch.parallel import mesh as M
    from ipdm_tpu_torch.recon.fbp import FBPGeometry
    from ipdm_tpu_torch.recon.geometry import FanBeamGeometry
    out = {}

    # make_mesh: None, -1 in either place, and a shape that misses
    shapes = [None, [2, -1], [-1, 2]]
    out["shapes"] = [tuple(M.make_mesh(s).shape) for s in shapes]
    try:
        M.make_mesh([4, 1])
    except ValueError as e:
        out["bad_shape"] = str(e)
    dp = M.make_mesh([2, 1])
    vw = M.make_mesh([1, 2])
    try:
        M.shard_batch(np.zeros((3, 1)), dp)
    except ValueError as e:
        out["bad_batch"] = str(e)

    # the data-parallel step, from the parent's seeded init: each step's
    # loss, and the first step's all-reduced gradients and parameters
    out["train"] = {}
    for name in ("convnet", "unet"):
        model = train_model(name, inp["train_cfg"])
        gd = GaussianDiffusion(100, "cosine", device="cpu")
        opt = make_optimizer(model.parameters(), 1e-3)
        gen = torch.Generator().manual_seed(1)
        step = M.make_sharded_train_step(model, gd, opt, 50, dp, gen)
        r = out["train"][name] = {"losses": [float(step(inp["images"]))]}
        r["grads"] = {k: _np(p.grad) for k, p in model.named_parameters()}
        r["params"] = {k: _np(v) for k, v in model.state_dict().items()}
        r["losses"].append(float(step(inp["images"])))

    # view-sharded FBP (whole sinogram in, and this rank's wedge in) / FP
    g = FBPGeometry(**inp["fbp_geom"])
    fbp = M.make_view_sharded_fbp(vw, g, view_block=5)
    pj = torch.from_numpy(inp["pj"])
    out["fbp"] = _np(fbp(pj))
    per = g.M // 2
    out["fbp_wedge"] = _np(fbp(pj[:, rank * per:(rank + 1) * per]))
    geom = FanBeamGeometry(**inp["fan_geom"])
    fp = M.make_view_sharded_fp(vw, geom, inp["lut"], inp["betas"])
    out["fp"] = _np(fp(torch.from_numpy(inp["phantom"])))

    # one 3×3 conv and one planar unit (GN → SiLU → conv) on H-bands
    band = M._Bands(dist.group.WORLD, SimpleNamespace(
        channel_mult=(1, 1, 1), attention_resolutions=()), 32)
    x = M.shard_rows(torch.from_numpy(inp["conv_x"]), dp)
    conv = torch.nn.Conv2d(4, 4, 3, padding=1)
    conv.load_state_dict({k: torch.from_numpy(v)
                          for k, v in inp["conv_w"].items()})
    gn = GroupNorm(4)
    with torch.no_grad():
        out["conv"] = _np(M.gather_rows(
            conv_unit(conv, x, False, band=band), dp))
        out["planar"] = _np(M.gather_rows(
            conv_unit(conv, x, True, gn=gn, band=band), dp))
        xg = M.shard_rows(torch.from_numpy(inp["gn_x"]), dp)
        out["gn"] = _np(M.gather_rows(GroupNorm(4)(xg, band), dp))

    # the UNet on H-bands, for each config the parent gives
    out["unet"] = []
    for cfg, sd, ux in inp["unets"]:
        m = UNetModel(**cfg, device="cpu")
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        apply = M.make_spatial_sharded_apply(m, dp)
        with torch.no_grad():
            y = apply(M.shard_rows(torch.from_numpy(ux), dp),
                      torch.zeros(ux.shape[0], dtype=torch.long))
        out["unet"].append((_np(M.gather_rows(y, dp)),
                            M._Bands(M._group(dp, "data"), m,
                                     ux.shape[2] // 2).banded))
    return out


def engine_run(rank, tmp, cfgs):
    """The engine under mesh_shape [2, 1]: each of ``cfgs`` (IPDMConfig
    keyword dicts) fit() in turn, each rank writing under tmp/out{rank};
    returns the train steps' losses, the trained img weights, the test
    slice's iterations and the files the rank wrote."""
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
    out = {"losses": []}
    # a global batch that does not divide over the 2 ranks: refused when
    # the engine is built, before any model or data
    try:
        ProgressiveDomainDenoiser(IPDMConfig(
            device="cpu", mesh_shape=[2, 1], **dict(
                cfgs["train"], batch_size=1, patch=None)),
            result_save_path=osp.join(tmp, f"out{rank}"))
    except ValueError as e:
        out["bad_batch"] = str(e)
    for name, cfg in cfgs.items():
        opt = IPDMConfig(device="cpu", mesh_shape=[2, 1], **cfg)
        eng = ProgressiveDomainDenoiser(
            opt, result_save_path=osp.join(tmp, f"out{rank}"))
        train = eng.train
        eng.train = lambda *a: out["losses"].append(train(*a))
        eng.fit()
        if eng.img_model is not None and opt.mode == "train_img":
            out[name] = {k: _np(v)
                         for k, v in eng.img_model.state_dict().items()}
        else:
            out[name] = dict(eng.progressive_denoise_result,
                             **{f"proj_{k}": v for k, v in
                                eng.proj_denoise_convert2img_result.items()})
    root = osp.join(tmp, f"out{rank}")
    out["files"] = sorted(osp.relpath(osp.join(d, f), root)
                          for d, _, fs in os.walk(root) for f in fs)
    out["dirs"] = osp.exists(root)
    return out


def dryrun_step(rank, tmp, perturb):
    """Check 3 of scripts/multihost_dryrun_torch.py on this rank, with
    ``perturb`` added to rank 1's half of the batch; returns the loss."""
    import sys
    sys.path.insert(0, osp.join(osp.dirname(osp.dirname(
        osp.abspath(__file__))), "scripts"))
    import multihost_dryrun_torch as mh
    from ipdm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([2, 1], ("data", "view"), "cpu")
    return mh.dp_step_check(rank, mesh, torch.device("cpu"),
                            perturb if rank == 1 else 0.0)["loss"]

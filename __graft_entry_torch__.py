"""A compile check and a multi-rank dry run of the PyTorch/CUDA port:
the twin of ``__graft_entry__.py``.

``entry()`` returns one guided reverse denoising step on the flagship
image-domain UNet (the hot function of IPDM inference) and its example
arguments. ``dryrun_multichip(n)`` runs n ranks of one gloo process group
(``ipdm_tpu_torch/parallel/spawn.py``) over a (data × view) mesh: one
data-parallel training step, one view-sharded FBP, an H-sharded UNet eval
and the H-sharded guided sampler, each against its unsharded run, on
``__graft_entry__.py``'s tiny shapes. On one card the ranks share
``cuda:0``; the JAX dry run's virtual CPU devices (XLA flags) have no
counterpart.

    python __graft_entry_torch__.py            # entry() on the card
    python __graft_entry_torch__.py --device cpu
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import tempfile
import time

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import numpy as np
import torch


def _small_img_unet(device):
    """The flagship architecture (img domain) at 16 channels: the levels
    and attention placement of the real one (__graft_entry__.py:14-29),
    weights drawn from seed 0."""
    from ipdm_tpu_torch.models.unet import UNetModel

    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(0)
        return UNetModel(in_channels=1, model_channels=16, out_channels=1,
                         num_res_blocks=2, attention_resolutions=(16,),
                         channel_mult=(1, 1, 2, 2, 4, 4),
                         device=device).eval()


def entry(device=None):
    """One guided reverse diffusion step on the flagship model (UNet
    ε-prediction + guidance blend + posterior sample) at 64², t = 10,
    λ = 0.45. Returns (fn, example_args): ``fn(model, x_t, x_cond, t,
    generator)`` with the model as the first argument (the counterpart of
    the JAX params), NCHW images and an explicit ``torch.Generator``.

    x_t is 0.5 everywhere, as in ``__graft_entry__.entry``; x_cond is a
    seeded uniform image there. (With x_cond = x_t, as the JAX example
    has it, the guidance's condition noise is one constant whose std is
    0, and the step is 0/0: NaN here, as in the reference's torch.std,
    and a value set by rounding in the JAX package.)"""
    from ipdm_tpu_torch import resolve_device
    from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion

    dev = resolve_device(device)
    model = _small_img_unet(dev)
    gd = GaussianDiffusion(timesteps=1000, beta_schedule="cosine",
                           device=dev)

    def fn(model, x_t, x_cond, t, generator):
        with torch.no_grad():
            return gd.p_sample_condition(model, x_t, x_cond, t, generator,
                                         clip_denoised=True, lambda_=0.45)

    x = torch.full((1, 1, 64, 64), 0.5, device=dev)
    x_cond = torch.as_tensor(np.random.default_rng(1).random(
        (1, 1, 64, 64), np.float32), device=dev)
    t = torch.full((1,), 10, dtype=torch.long, device=dev)
    generator = torch.Generator(device=dev).manual_seed(1)
    return fn, (model, x, x_cond, t, generator)


def _dryrun_rank(rank, tmp, dev_type):
    """One rank of :func:`dryrun_multichip`: its numbers, after each
    sharded result was held to the unsharded one."""
    import torch.distributed as dist

    from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
    from ipdm_tpu_torch.diffusion.guided import guided_reverse_process
    from ipdm_tpu_torch.engine.trainer import make_optimizer
    from ipdm_tpu_torch.models.unet import UNetModel
    from ipdm_tpu_torch.parallel import mesh as M
    from ipdm_tpu_torch.recon.fbp import FBPGeometry

    n = dist.get_world_size()
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        from ipdm_tpu_torch.ops.cuda import _build
        _build.library()   # built by the parent: loaded here
    # 2-D mesh: batch data-parallel × view-parallel physics, as much on
    # 'view' as divides the tiny geometry
    view = 2 if n % 2 == 0 else 1
    data = n // view
    mesh = M.make_mesh([data, view], device_type=dev.type)

    # --- sharded training step (dp over batch): 2 levels, 1 res block,
    # attention at ds 2 (__graft_entry__.py:155-160)
    torch.manual_seed(0)
    model = UNetModel(in_channels=1, model_channels=8, out_channels=1,
                      num_res_blocks=1, attention_resolutions=(2,),
                      channel_mult=(1, 2), device=dev)
    gd = GaussianDiffusion(100, "cosine", device=dev)
    opt = make_optimizer(model.parameters(), 2e-4)
    gen = torch.Generator(device=dev).manual_seed(1)
    step = M.make_sharded_train_step(model, gd, opt, 50, mesh, gen)
    B = 2 * data  # divisible by the data axis
    images = torch.as_tensor(np.random.default_rng(0).random(
        (B, 16, 16, 1), np.float32), device=dev)
    loss = float(step(images))
    assert np.isfinite(loss), loss

    # --- view-sharded FBP (sp over the sinogram view axis)
    g = FBPGeometry(n_det=32, n_views=8 * view, grid_n=16, grid_l=21.0)
    fbp = M.make_view_sharded_fbp(mesh, g, view_block=4)
    img = fbp(torch.ones((1, g.M, g.N), device=dev))
    assert tuple(img.shape) == (1, 16, 16), img.shape
    assert bool(torch.isfinite(img).all())

    # --- H-sharded UNet eval: image rows over every mesh axis (at n = 2
    # the data axis holds one rank), against the unsharded eval
    axes = tuple(mesh.mesh_dim_names)
    apply = M.make_spatial_sharded_apply(model, mesh, axes)

    def sharded(x, t):
        return M.gather_rows(apply(M.shard_rows(x, mesh, axes), t), mesh,
                             axes)

    xin = torch.full((1, 1, 16, 16), 0.5, device=dev)
    tin = torch.full((1,), 3, dtype=torch.long, device=dev)
    with torch.no_grad():
        y_sp, y_ref = sharded(xin, tin), model(xin, tin)
    # f32 sums reordered over the sharded GroupNorm statistics and the
    # convolutions' halo rows (~1e-6); a wrong halo or a missing
    # collective is an O(1) error (__graft_entry__.py:181-186)
    np.testing.assert_allclose(y_sp.cpu().numpy(), y_ref.cpu().numpy(),
                               rtol=1e-2, atol=1e-3)

    # --- the guided sampler on H-bands against the unsharded sampler,
    # the same generator seed on both
    x0 = torch.as_tensor(np.random.default_rng(2).random(
        (1, 1, 16, 16), np.float32), device=dev)
    outs = []
    with torch.no_grad():
        for fn in (sharded, model):
            g7 = torch.Generator(device=dev).manual_seed(7)
            outs.append(guided_reverse_process(
                fn, gd, x0, g7, t_start=[2, 2], mode="img",
                constant_guidance=0.45)[0][-1])
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(),
                               rtol=1e-2, atol=1e-3)
    return dict(mesh={"data": data, "view": view}, loss=loss,
                eval_d=float((y_sp - y_ref).abs().max()),
                sampler_d=float((outs[0] - outs[1]).abs().max()))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Validate the multi-rank path on ``n_devices`` gloo ranks: the
    dp-sharded training step, the view-sharded FBP, the H-sharded UNet
    eval and guided sampler, one real step each, tiny shapes. On the card
    every rank runs on ``cuda:0``. Prints one ``dryrun_multichip OK`` line
    with the wall time and returns rank 0's numbers."""
    from ipdm_tpu_torch import resolve_device
    from ipdm_tpu_torch.parallel.spawn import run_ranks

    t0 = time.time()
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ipdm_tpu_torch.ops.cuda import _build
        _build.library()   # one build before the ranks load it
    with tempfile.TemporaryDirectory(prefix="ipdm_dryrun_") as tmp:
        res = run_ranks(_dryrun_rank, n_devices, tmp, args=(dev.type,),
                        timeout=600.0)
    r = res[0]
    assert all(x["loss"] == r["loss"] for x in res), res
    print(f"dryrun_multichip OK: mesh={r['mesh']}, loss={r['loss']:.5f}, "
          f"sp-eval max|d|={r['eval_d']:.2e}, sharded-sampler max|d|="
          f"{r['sampler_d']:.2e}, device={dev.type}, "
          f"wall={time.time() - t0:.0f}s", flush=True)
    return r


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    fn, args = entry(a.device)
    out = fn(*args)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("entry: the step is not finite")
    print("entry OK:", tuple(out.shape))

"""End-to-end IPDM workflow of the PyTorch/CUDA port on a synthetic
corpus: the twin of ``examples/synthetic_e2e.py``.

Steps (sizes configurable):
  1. synthesise random-ellipse μ phantoms (recon.phantom), forward-project
     them (``project_fast``) and simulate the low dose (recon.simulate, the
     reference's noise model) to build the four-stream dataset layout
     ``SiemensDatasetNpz`` expects;
  2. train the image-domain DDPM (mode ``train_img``) on the full-dose
     images for ``max(1, iters // n)`` whole epochs of the ``n`` slices at
     batch 1 (192 steps at ``--n 16 --iters 200``);
  3. train the projection-domain DDPM (mode ``train_proj``) on the
     full-dose sinograms;
  4. run the progressive dual-domain test (mode ``test_prog``) on those
     checkpoints, writing the reference's artifact layout, and print the
     aggregate metrics (LDCT baseline, deProj, deProg).

Usage (the card; ``--size 512`` is the SIEMENS scanner, 2000×912):
    python examples/synthetic_e2e_torch.py --out /tmp/ipdm_synth_torch \\
        --n 4 --size 512 --full-arch --iters 200
On the CPU, small:
    python examples/synthetic_e2e_torch.py --device cpu --n 2 --size 64
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np

STREAMS = ("fd_img", "ld_img", "fd_proj", "ld_proj")
FULL_ARCH = dict(model_channels_img=64, channel_mult_img=[1, 1, 2, 2, 4, 4],
                 attention_resolutions_img=[16], model_channels_proj=64,
                 channel_mult_proj=[0.0625, 0.125, 0.25, 2, 2, 4, 4],
                 attention_resolutions_proj=[32])
SMALL_ARCH = dict(model_channels_img=16, channel_mult_img=[1, 1, 2, 2],
                  attention_resolutions_img=[8], model_channels_proj=16,
                  channel_mult_proj=[1, 1, 2, 2],
                  attention_resolutions_proj=[8])


def make_geom(size: int):
    from ipdm_tpu_torch.recon.geometry import SIEMENS, FanBeamGeometry
    if size == 512:
        return SIEMENS   # the true scanner geometry (2000×912)
    return FanBeamGeometry(nx=size, ny=size, dx=42 / size, dy=42 / size,
                           nr=2 * size, dr=0.0010125 * 912 / (2 * size),
                           na=360, ta_dimx=401, ta_dimy=91)


def geometry_overrides(size: int):
    """The ``geometry`` entry of an IPDMConfig for :func:`make_geom`."""
    if size == 512:
        return None
    gm = make_geom(size)
    return dict(nx=gm.nx, ny=gm.ny, dx=gm.dx, dy=gm.dy, nr=gm.nr, dr=gm.dr,
                na=gm.na, ta_dimx=gm.ta_dimx, ta_dimy=gm.ta_dimy)


def dataset_paths(out: str) -> dict:
    """The corpus as both the training and the test set."""
    return {f"{m}_dataset_path_{k}": osp.join(out, s)
            for m in ("train", "test")
            for k, s in (("FD_img", "fd_img"), ("LD_img", "ld_img"),
                         ("FD_proj", "fd_proj"), ("LD_proj", "ld_proj"))}


def build_dataset(out: str, n_slices: int, size: int, dose: float, seed=0,
                  recon="SART", device=None):
    """Phantoms → project_fast → add_noise → the low-dose reconstruction,
    saved as the four streams under ``out``/<stream>/P001/NNNN.npy."""
    import torch
    from ipdm_tpu_torch import resolve_device
    from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
    from ipdm_tpu_torch.recon.fbp_fast import fbp_convert_fast
    from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom
    from ipdm_tpu_torch.recon.sart_fast import project_fast, sart_fast_convert
    from ipdm_tpu_torch.recon.simulate import add_noise

    dev = resolve_device(device)
    geom = make_geom(size)
    g = fbp_geom_from_fan(geom)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for s in STREAMS:
        os.makedirs(osp.join(out, s, "P001"), exist_ok=True)
    for i in range(n_slices):
        ph = random_ellipse_phantom(size, rng)
        vol = torch.as_tensor(ph[None], dtype=torch.float32, device=dev)
        fd_proj = project_fast(vol, g, geom.nr, float(g.nda[0]), float(g.da))
        ld_proj = add_noise(fd_proj, gen, dose)
        if recon == "SART":
            ld_img = sart_fast_convert(ld_proj, g, nstart=4,
                                       nsubsets=min(18, geom.na))
        else:
            ld_img = fbp_convert_fast(ld_proj, g)
        fd_img = vol.transpose(1, 2)  # recon orientation
        for s, arr in zip(STREAMS, (fd_img, ld_img, fd_proj, ld_proj)):
            np.save(osp.join(out, s, "P001", f"{i:04d}.npy"),
                    arr[0].cpu().numpy())
    return geom


def write_checkpoints(out: str, opt, seed: int = 0, device=None) -> str:
    """One ``{img,proj}_model-1`` checkpoint from seeded random weights
    of the models ``opt`` (an IPDMConfig) names, written with the port's
    CheckpointManager; returns the directory (``chip_smoke.py``'s engine
    phase tests the engine on these, before its train phase)."""
    import torch
    from ipdm_tpu_torch import resolve_device
    from ipdm_tpu_torch.engine.checkpoint import CheckpointManager
    from ipdm_tpu_torch.models.unet import build_unet

    dev = resolve_device(device)
    ckpt = CheckpointManager(osp.join(out, "seeded_models"))
    cuda = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(seed + 1000)
        for domain in ("img", "proj"):
            ckpt.save(f"{domain}_model", 1,
                      build_unet(opt, domain, device=dev))
    return ckpt.dir


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/ipdm_synth_torch")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--dose", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=20,
                    help="training budget per domain: the script runs "
                    "max(1, iters // n) whole epochs of the n slices at "
                    "batch 1 (192 steps at n = 16, iters = 200)")
    ap.add_argument("--recon", default="SART", choices=["SART", "FBP"])
    ap.add_argument("--convertor", default="FBP", choices=["FBP", "ART"])
    ap.add_argument("--full-arch", action="store_true",
                    help="use the reference model sizes (ch=64)")
    ap.add_argument("--test-slices", type=int, default=4)
    ap.add_argument("--skip-build", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def common_options(args) -> dict:
    """The IPDMConfig fields that the train and test runs share."""
    return dict(device=args.device, seed=args.seed, test_numbers=0,
                geometry=geometry_overrides(args.size),
                metrics=["psnr", "ssim"], timesteps_img=1000,
                timesteps_proj=1000, partial_timesteps_img=50,
                partial_timesteps_proj=50, batch_size=1,
                patch=None, patch_per_image=None, init_lr=2e-4,
                save_freq=max(1, args.iters),
                max_epochs=max(1, args.iters // args.n),
                **(FULL_ARCH if args.full_arch else SMALL_ARCH),
                **dataset_paths(args.out))


def train_models(args, common: dict) -> dict:
    """Steps 2-3: train_img then train_proj through the engine; returns
    each domain's checkpoint directory."""
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser

    dirs = {}
    for step, domain in ((2, "img"), (3, "proj")):
        print(f"[{step}/4] training the {domain} model...", flush=True)
        opt = IPDMConfig(mode=f"train_{domain}", run_name=f"synth_{domain}",
                         **common)
        eng = ProgressiveDomainDenoiser(opt, result_save_path=args.out)
        eng.fit()
        eng.checkpoints(1)
        dirs[domain] = eng.logger.models_save_dir
    return dirs


def progressive_test(args, common: dict, dirs: dict, convertor: str):
    """Step 4: test_prog on the checkpoints in ``dirs`` with
    ``convertor``; returns (LDCT PSNR, best deProj PSNR, best deProg
    PSNR, the aggregate metric.json)."""
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser

    opt = IPDMConfig(mode="test_prog", run_name="synth_prog",
                     convertor=convertor, fbp_sharpen=False,
                     ultra_img_denoise=False,
                     t_start_img=[10, 10], constant_guidance_img=0.45,
                     t_start_proj=[10, 10], constant_guidance_proj=0.5,
                     resume_epochs_img=1, resume_epochs_proj=1,
                     load_img_model_path=dirs["img"],
                     load_proj_model_path=dirs["proj"], **common)
    opt.test_numbers = min(args.test_slices, args.n)
    eng = ProgressiveDomainDenoiser(opt, result_save_path=args.out)
    eng.fit()
    agg = osp.join(eng.save_root_path, "Save_Iter_0", "metric.json")
    with open(agg) as f:
        m = json.load(f)
    best = {g: max(v for k, v in m[g].items()
                   if k.startswith("psnr") and not k.endswith("_std"))
            for g in ("deProj", "deProg")}
    return (float(m["LDCT"]["psnr_iter_0"]), float(best["deProj"]),
            float(best["deProg"]), m)


def main(argv=None):
    args = parse_args(argv)
    if not args.skip_build:
        print("[1/4] building synthetic dataset...", flush=True)
        build_dataset(args.out, args.n, args.size, args.dose,
                      seed=args.seed, recon=args.recon, device=args.device)
    common = common_options(args)
    dirs = train_models(args, common)
    print("[4/4] progressive test...", flush=True)
    ldct, deproj, deprog, m = progressive_test(args, common, dirs,
                                               args.convertor)
    print(json.dumps(m, indent=2))
    print(f"LDCT PSNR {ldct:.2f} → deProj {deproj:.2f} → deProg "
          f"{deprog:.2f} (after {args.iters} iterations: deProg need not "
          f"beat LDCT)")
    return ldct, deproj, deprog, m


if __name__ == "__main__":
    main()

"""Ablation studies of the PyTorch/CUDA port: the twin of
``examples/ablations.py`` (the reference notebook's analysis cells,
test_sample.ipynb cells 5-22: dose / NFE / guidance / convertor
ablations, HU-drift curves, residual-noise histograms).

Runs on the synthetic corpus of ``examples/synthetic_e2e_torch.py``, with
the engine's notebook API: one ProgressiveDomainDenoiser is built, then
``update_opt(...)`` hot-swaps sampler and convertor settings per
configuration and ``reset_opt()`` restores the options, as the notebook
does (reference train_test_utils.py:202-211). ``reset_opt`` restores the
options but not the convertor (the JAX package's engine does the same),
so in ``--study all`` the hu-drift and noise-hist studies run on the TV
convertor that ``study_recon`` built last.

Usage (the card; ``--size 512`` is the SIEMENS scanner, 2000×912):
    python examples/ablations_torch.py --out /tmp/ipdm_abl_torch \\
        --study all --size 512 --n 4 --iters 8 --test-slices 1
On the CPU, small:
    python examples/ablations_torch.py --device cpu --out /tmp/abl \\
        --study nfe --n 2 --size 32 --iters 2 --test-slices 1

Outputs per study: <out>/ablation_<study>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np

from examples.synthetic_e2e_torch import (build_dataset, dataset_paths,
                                          geometry_overrides)

# the fixed UNets of the studies (examples/ablations.py:245-248)
ARCH = dict(model_channels_img=16, channel_mult_img=[1, 1, 2, 2],
            attention_resolutions_img=[8],
            model_channels_proj=16, channel_mult_proj=[1, 1, 2, 2],
            attention_resolutions_proj=[8])


def _train_models(out, n, size, dose, iters, arch, paths, geo,
                  device="cuda", seed=0):
    """Train img+proj DDPMs once; return (img_dir, proj_dir, common)."""
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser

    common = dict(device=device, seed=seed, batch_size=1, save_freq=iters,
                  test_numbers=0, init_lr=2e-4, geometry=geo,
                  metrics=["psnr", "ssim"], patch=None, patch_per_image=None,
                  timesteps_img=1000, partial_timesteps_img=50,
                  timesteps_proj=1000, partial_timesteps_proj=50,
                  max_epochs=max(1, iters // n), **arch, **paths)
    dirs = {}
    for domain in ("img", "proj"):
        opt = IPDMConfig(mode=f"train_{domain}", run_name=f"abl_{domain}",
                         **common)
        eng = ProgressiveDomainDenoiser(opt, result_save_path=out)
        eng.fit()
        eng.checkpoints(1)
        dirs[domain] = eng.logger.models_save_dir
    return dirs["img"], dirs["proj"], common


def _test_engine(out, common, img_dir, proj_dir, **kw):
    from ipdm_tpu_torch.config.config import IPDMConfig
    from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser

    opt = IPDMConfig(mode="test_prog", run_name="abl_test",
                     convertor="FBP", fbp_sharpen=False,
                     ultra_img_denoise=False,
                     t_start_img=[10, 10], constant_guidance_img=0.45,
                     t_start_proj=[10, 10], constant_guidance_proj=0.5,
                     resume_epochs_img=1, resume_epochs_proj=1,
                     load_img_model_path=img_dir,
                     load_proj_model_path=proj_dir,
                     **dict(common, **kw))
    return ProgressiveDomainDenoiser(opt, result_save_path=out)


def _load_sample(eng, i):
    ld_img, fd_proj, fd_img, ld_proj = eng.test_dataset[i]
    eng.temp_clear()
    eng.data_sample_load(
        ldct=None if ld_img is None else ld_img[None],
        ldproj=None if ld_proj is None else ld_proj[None],
        fdproj=fd_proj,
        fdct=None if fd_img is None else fd_img[None])


def _denoise_samples(eng, ids):
    """Run the progressive pipeline on test samples; return per-sample
    (ld, fd, deprog) pixel-domain arrays (eng.ldct_np / eng.fdct are already
    μ→pixel converted, data_sample_load semantics of the reference)."""
    from ipdm_tpu_torch.data.units import miu2pixel

    outs = []
    for i in ids:
        _load_sample(eng, i)
        result = eng.progressive_denoiser()
        dp = miu2pixel(result.detach().cpu().numpy()[0, ..., 0])
        outs.append((eng.ldct_np, eng.fdct, dp))
    return outs


def _psnr(a, b):
    from ipdm_tpu_torch.metrics.psnr_ssim import psnr
    return psnr(np.clip(a, 0, 1), np.clip(b, 0, 1), data_range=1.0)


def study_dose(args, arch, paths, geo):
    """Dose ablation (notebook cell 12): metric vs dose ∈ {.05,.1,.15,.25}."""
    res = {}
    for dose in (0.05, 0.10, 0.15, 0.25):
        droot = osp.join(args.out, f"dose_{dose:g}")
        build_dataset(droot, args.n, args.size, dose, seed=args.seed,
                      device=args.device)
        dpaths = {k: v.replace(args.data, droot) for k, v in paths.items()}
        img_dir, proj_dir, common = _train_models(
            droot, args.n, args.size, dose, args.iters, arch, dpaths, geo,
            args.device, args.seed)
        eng = _test_engine(droot, common, img_dir, proj_dir)
        outs = _denoise_samples(eng, list(range(args.test_slices)))
        res[str(dose)] = {
            "ldct_psnr": float(np.mean([_psnr(ld, fd) for ld, fd, _ in outs])),
            "deprog_psnr": float(np.mean([_psnr(dp, fd)
                                          for _, fd, dp in outs])),
        }
        print(f"dose {dose}: {res[str(dose)]}", flush=True)
    return res


def study_nfe(args, eng):
    """NFE ablation (notebook cell 17): quality vs NFE budget, dense t_start
    grids and sparse DDIM (ddim_timesteps) configs."""
    configs = [
        ("dense_2x5", dict(t_start_img=[5, 5], t_start_proj=[5, 5],
                           sample_method_img="dense",
                           sample_method_proj="dense"), 20),
        ("dense_2x10", dict(t_start_img=[10, 10], t_start_proj=[10, 10],
                            sample_method_img="dense",
                            sample_method_proj="dense"), 40),
        ("dense_3x15", dict(t_start_img=[15, 15, 15],
                            t_start_proj=[15, 15, 15],
                            sample_method_img="dense",
                            sample_method_proj="dense"), 90),
        ("sparse_ddim_123", dict(sample_method_img="sparse",
                                 sample_method_proj="sparse",
                                 ddim_timesteps_img=[1, 2, 3],
                                 ddim_timesteps_proj=[1, 2, 3],
                                 t_start_img=[10], t_start_proj=[10]), 12),
    ]
    res = {}
    for name, cfg, nfe in configs:
        eng.update_opt(cfg)                      # notebook-style hot swap
        outs = _denoise_samples(eng, list(range(args.test_slices)))
        res[name] = {
            "nfe": nfe,
            "deprog_psnr": float(np.mean([_psnr(dp, fd)
                                          for _, fd, dp in outs])),
        }
        print(f"nfe {name}: {res[name]}", flush=True)
        eng.reset_opt()
    return res


def study_guidance(args, eng):
    """Constant-guidance λ ablation (notebook condition cells)."""
    res = {}
    for lam in (0.2, 0.45, 0.7):
        eng.update_opt(dict(constant_guidance_img=lam))
        outs = _denoise_samples(eng, list(range(args.test_slices)))
        res[str(lam)] = float(np.mean([_psnr(dp, fd) for _, fd, dp in outs]))
        print(f"guidance {lam}: {res[str(lam)]:.2f} dB", flush=True)
        eng.reset_opt()
    return res


def study_recon(args, eng):
    """Convertor ablation (notebook recon cells): FBP vs ART vs TV, plus the
    convertor-only baselines (benchmark_test, reference model.py:521-523)."""
    res = {}
    for conv in ("FBP", "ART", "TV"):
        for bench in (False, True):
            eng.update_opt(dict(convertor=conv, benchmark_test=bench))
            outs = _denoise_samples(eng, list(range(args.test_slices)))
            key = f"{conv}{'_only' if bench else '_ipdm'}"
            res[key] = float(np.mean([_psnr(dp, fd) for _, fd, dp in outs]))
            print(f"recon {key}: {res[key]:.2f} dB", flush=True)
            eng.reset_opt()
    return res


def study_hu_drift(args, eng):
    """HU-drift (reference 'HU Drift.png'): mean HU of each progressive
    iteration's output vs the full-dose mean."""
    from ipdm_tpu_torch.data.units import miu2HU, pixel2miu

    eng.update_opt(dict(save_it_state_img=True, save_it_state_proj=True))
    _load_sample(eng, 0)
    eng.progressive_denoiser()
    eng.reset_opt()
    drift = {"fd_mean_hu": float(np.mean(miu2HU(pixel2miu(eng.fdct)))),
             "ld_mean_hu": float(np.mean(miu2HU(pixel2miu(eng.ldct_np))))}
    for k, v in eng.img_denoise_result.items():
        drift[f"img_{k}_mean_hu"] = float(np.mean(miu2HU(np.asarray(v))))
    print(f"HU drift: {drift}", flush=True)
    return drift


def study_noise_hist(args, eng):
    """Residual-noise histograms (reference 'Hist of noise.png'):
    LD−FD vs deProg−FD residual distributions."""
    outs = _denoise_samples(eng, [0])
    ld, fd, dp = outs[0]
    r_in = (ld - fd).ravel()
    r_out = (dp - fd).ravel()
    bins = np.linspace(-0.2, 0.2, 81)
    res = {
        "bins": bins.tolist(),
        "hist_input": np.histogram(r_in, bins)[0].tolist(),
        "hist_deprog": np.histogram(r_out, bins)[0].tolist(),
        "std_input": float(r_in.std()),
        "std_deprog": float(r_out.std()),
    }
    print(f"noise std: input {res['std_input']:.4f} → "
          f"deprog {res['std_deprog']:.4f}", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/ipdm_abl_torch")
    ap.add_argument("--study", default="all",
                    choices=["all", "dose", "nfe", "guidance", "recon",
                             "hu-drift", "noise-hist"])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--dose", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--test-slices", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    args.data = osp.join(args.out, "data")
    os.makedirs(args.out, exist_ok=True)
    print("[setup] corpus + base models...", flush=True)
    build_dataset(args.data, args.n, args.size, args.dose, seed=args.seed,
                  device=args.device)
    geo = geometry_overrides(args.size)
    paths = dataset_paths(args.data)
    img_dir, proj_dir, common = _train_models(
        args.out, args.n, args.size, args.dose, args.iters, ARCH, paths, geo,
        args.device, args.seed)
    eng = _test_engine(args.out, common, img_dir, proj_dir)

    studies = {
        "nfe": lambda: study_nfe(args, eng),
        "guidance": lambda: study_guidance(args, eng),
        "recon": lambda: study_recon(args, eng),
        "hu-drift": lambda: study_hu_drift(args, eng),
        "noise-hist": lambda: study_noise_hist(args, eng),
        "dose": lambda: study_dose(args, ARCH, paths, geo),
    }
    wanted = list(studies) if args.study == "all" else [args.study]
    for name in wanted:
        print(f"=== study: {name} ===", flush=True)
        res = studies[name]()
        with open(osp.join(args.out, f"ablation_{name}.json"), "w") as f:
            json.dump(res, f, indent=2)
    print("done; results in", args.out)


if __name__ == "__main__":
    main()

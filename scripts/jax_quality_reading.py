"""The JAX package's reading of the quality contract (CPU, 64²), with
both convertors on the same checkpoints.

``examples/synthetic_e2e.py``'s steps at ``tests/test_quality.py``'s
settings (16 random-ellipse slices at 64², dose 0.25, the SART-built
low-dose images, SMALL_ARCH UNets trained 12 epochs of the 16 slices a
domain, test_prog on 4 slices with t_start [10, 10]), then test_prog
again on the same checkpoints with the ART convertor, which that example
does not offer. Prints LDCT / deProj / deProg PSNR and SSIM of both
runs, so that the port's readings at the same settings
(``examples/synthetic_e2e_torch.py``, ``tests/test_torch_quality.py``,
``chip_smoke.py``'s ``quality:`` phase) have a like-for-like yardstick.
The two packages draw different low-dose noise, so their corpora differ
by that draw. Training reads the corpus through the Python loader
(``native_loader=False``): the JAX engine's two-worker native loader can
livelock (ROADMAP Queue 3), and did so here within 70 steps.

Run: python scripts/jax_quality_reading.py [--out DIR] (the JAX package
on the CPU; tens of minutes).
"""
import argparse
import json
import os
import os.path as osp
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, osp.join(ROOT, "examples"))

N, SIZE, ITERS, TEST_SLICES, DOSE = 16, 64, 200, 4, 0.25
SMALL_ARCH = dict(model_channels_img=16, channel_mult_img=[1, 1, 2, 2],
                  attention_resolutions_img=[8], model_channels_proj=16,
                  channel_mult_proj=[1, 1, 2, 2],
                  attention_resolutions_proj=[8])


def groups(m: dict) -> str:
    return "; ".join(
        f"{g} " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(m[g].items())
                            if not k.endswith("_std"))
        for g in ("LDCT", "deProj", "deProg"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="ipdm_jax_quality_")

    from synthetic_e2e import build_dataset, make_geom
    from ipdm_tpu.config.config import IPDMConfig
    from ipdm_tpu.engine.denoiser import ProgressiveDomainDenoiser

    t0 = time.perf_counter()
    build_dataset(out, N, SIZE, DOSE, recon="SART")
    gm = make_geom(SIZE)
    paths = {f"{m}_dataset_path_{k}": osp.join(out, s)
             for m in ("train", "test")
             for k, s in (("FD_img", "fd_img"), ("LD_img", "ld_img"),
                          ("FD_proj", "fd_proj"), ("LD_proj", "ld_proj"))}
    common = dict(batch_size=1, save_freq=ITERS, test_numbers=0,
                  native_loader=False,
                  init_lr=2e-4, metrics=["psnr", "ssim"], patch=None,
                  patch_per_image=None, timesteps_img=1000,
                  partial_timesteps_img=50, timesteps_proj=1000,
                  partial_timesteps_proj=50, max_epochs=max(1, ITERS // N),
                  geometry=dict(nx=gm.nx, ny=gm.ny, dx=gm.dx, dy=gm.dy,
                                nr=gm.nr, dr=gm.dr, na=gm.na,
                                ta_dimx=gm.ta_dimx, ta_dimy=gm.ta_dimy),
                  **SMALL_ARCH, **paths)
    dirs = {}
    for domain in ("img", "proj"):
        opt = IPDMConfig(mode=f"train_{domain}", run_name=f"synth_{domain}",
                         **common)
        eng = ProgressiveDomainDenoiser(opt, result_save_path=out)
        eng.fit()
        eng.checkpoints(1)
        dirs[domain] = eng.logger.models_save_dir
    t_train = time.perf_counter() - t0
    for conv in ("FBP", "ART"):
        t1 = time.perf_counter()
        opt = IPDMConfig(mode="test_prog", run_name=f"synth_prog_{conv}",
                         convertor=conv, fbp_sharpen=False,
                         ultra_img_denoise=False,
                         t_start_img=[10, 10], constant_guidance_img=0.45,
                         t_start_proj=[10, 10], constant_guidance_proj=0.5,
                         resume_epochs_img=1, resume_epochs_proj=1,
                         load_img_model_path=dirs["img"],
                         load_proj_model_path=dirs["proj"], **common)
        opt.test_numbers = TEST_SLICES
        eng = ProgressiveDomainDenoiser(opt, result_save_path=out)
        eng.test(0)
        with open(osp.join(eng.save_root_path, "Save_Iter_0",
                           "metric.json")) as f:
            m = json.load(f)
        print(f"jax quality {conv}: {groups(m)} "
              f"(corpus + training {t_train:.1f} s, test "
              f"{time.perf_counter() - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main()

"""Training-step time of the PyTorch/CUDA port on one card: the twin of
``examples/bench_train.py``.

Times the train step (q_sample → UNet forward and backward with remat →
Adam) of the image-domain UNet at 512² (B = 1 and 4) and of the
projection-domain UNet at 2000×912 (B = 1), at the widths and activation
dtype of the shipped train presets (``Config/Mayo-Config/
train_{img,proj}_option.json``: f32), with seeded random weights. Each
line gives ms per step (CUDA events over dependency-chained steps, after
warm-up steps), the peak device memory of a step and the kernel launches
per step.

    python examples/bench_train_torch.py [--steps 5] [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def preset(domain: str, dtype: str):
    """The train preset's options, with its device left to the port."""
    from ipdm_tpu_torch.config.config import IPDMConfig
    path = osp.join(ROOT, "Config", "Mayo-Config",
                    f"train_{domain}_option.json")
    with open(path) as f:
        opt = IPDMConfig().merge(json.load(f))
    opt.compute_dtype = dtype
    return opt


def bench(name, opt, domain, shape, steps, warmup=2, seed=0):
    """ms per train step of ``domain``'s UNet on [B, H, W, 1] images;
    returns (ms, peak GiB, launches per step, last loss)."""
    import numpy as np
    import torch
    from ipdm_tpu_torch.engine.denoiser import diffusion_for
    from ipdm_tpu_torch.engine.trainer import (make_optimizer,
                                               make_train_step)
    from ipdm_tpu_torch.models.unet import build_unet
    from ipdm_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda")
    torch.manual_seed(seed)
    model = build_unet(opt, domain, device=dev, remat=True)
    gd = diffusion_for(opt, domain, dev)
    step = make_train_step(model, gd, make_optimizer(model.parameters(),
                                                     opt.init_lr),
                           opt[f"partial_timesteps_{domain}"],
                           torch.Generator(device=dev).manual_seed(seed))
    images = torch.as_tensor(np.random.default_rng(seed).random(
        shape, np.float32), device=dev)
    for _ in range(warmup):
        step(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(steps):
        loss = step(images)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: v / steps for k, v in _build.LAUNCHES.items() if v}
    print(f"{name}: {ms:.1f} ms/step ({shape[0] * 1e3 / ms:.2f} samples/s), "
          f"peak {peak:.2f} GiB, launches per step {launches}, "
          f"loss {float(loss):.4f}", flush=True)
    return ms, peak, launches, float(loss)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_train_torch: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    img, proj = preset("img", args.dtype), preset("proj", args.dtype)
    tag = f"remat, {args.dtype}"
    bench(f"img train ({tag}) B=1 512^2", img, "img", (1, 512, 512, 1),
          args.steps)
    bench(f"img train ({tag}) B=4 512^2", img, "img", (4, 512, 512, 1),
          args.steps)
    bench(f"proj train ({tag}) B=1 2000x912", proj, "proj",
          (1, 2000, 912, 1), args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

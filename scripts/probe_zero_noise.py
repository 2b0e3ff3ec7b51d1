"""Where the guided sampler amplifies rounding when its noise is zero
(the port on the CPU, 32²).

chip_smoke.py's card-vs-CPU check of the ablation studies runs both
engines on one shared noise, because at zero noise the two devices'
results drifted apart past its 1e-3 rule. This probe measures why. It
builds chip_smoke.py's 32² corpus and seeded SMALL_ARCH checkpoints,
runs examples/ablations_torch.py's base configuration on one test slice
(FBP, t_start [10, 10] in both domains) once at zero noise and once on
chip_smoke.py's shared noise, and at every guided step
(GaussianDiffusion.p_mean_variance_condition) records:

* the cancellation of the condition noise ε_c = (x_t − √ᾱ·x₀)/√(1 − ᾱ):
  std(x_t − √ᾱ·x₀) / std(x_t);
* the rounding error of std_normalize(ε_c) computed in f32 against the
  same formula in f64 on the same f32 inputs, largest |diff| (the
  normalised noise is of unit std, so this is the step's error relative
  to its scale; f32's ulp at 1 is 1.2e-7).

It prints the smallest cancellation and the largest error per domain in
each run.

Run: python scripts/probe_zero_noise.py (the port only, about a minute).
"""
import collections
import os.path as osp
import sys
import tempfile

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from examples import ablations_torch as abl  # noqa: E402
from examples.synthetic_e2e_torch import (build_dataset,  # noqa: E402
                                          dataset_paths, geometry_overrides,
                                          write_checkpoints)
from ipdm_tpu_torch.config.config import IPDMConfig  # noqa: E402
from ipdm_tpu_torch.diffusion import diffusion  # noqa: E402
from ipdm_tpu_torch.diffusion.diffusion import (  # noqa: E402
    GaussianDiffusion, extract, std_normalize)


def main() -> int:
    d = tempfile.mkdtemp(prefix="probe-zero-noise-")
    n = cs.ABLATION_SMALL
    build_dataset(osp.join(d, "data"), 2, n, cs.DOSE, seed=cs.SEED,
                  device="cpu")
    common = dict(seed=cs.SEED, batch_size=1, save_freq=1, test_numbers=0,
                  init_lr=2e-4, geometry=geometry_overrides(n),
                  metrics=["psnr"], patch=None, patch_per_image=None,
                  timesteps_img=1000, partial_timesteps_img=50,
                  timesteps_proj=1000, partial_timesteps_proj=50,
                  max_epochs=1, device="cpu", **abl.ARCH,
                  **dataset_paths(osp.join(d, "data")))
    ckpt = write_checkpoints(d, IPDMConfig(**common), seed=cs.SEED,
                             device="cpu")
    stats = collections.defaultdict(list)
    domain = {}
    plain = GaussianDiffusion.p_mean_variance_condition

    def spy(self, model_fn, x_t, x_0, t, lambda_, clip_denoised=False):
        s = extract(self.sqrt_alphas_cumprod, t, x_0.ndim)
        s1 = extract(self.sqrt_one_minus_alphas_cumprod, t, x_0.ndim)
        diff = x_t - s * x_0
        got = std_normalize(diff / s1)
        want = std_normalize((x_t.double() - s.double() * x_0.double())
                             / s1.double())
        stats[domain[id(self)]].append(
            (float(diff.std() / x_t.std()),
             float((got.double() - want).abs().max())))
        return plain(self, model_fn, x_t, x_0, t, lambda_, clip_denoised)

    GaussianDiffusion.p_mean_variance_condition = spy
    zero = diffusion.noise_like
    try:
        for label, noise in (("zero noise", lambda x, g: torch.zeros_like(x)),
                             ("shared noise", cs._shared_noise(cs.SEED))):
            diffusion.noise_like = noise
            eng = abl._test_engine(osp.join(d, label), common, ckpt, ckpt)
            domain[id(eng.img_gaussian_diffusion)] = "img"
            domain[id(eng.proj_gaussian_diffusion)] = "proj"
            stats.clear()
            abl._denoise_samples(eng, [0])
            for dom in ("proj", "img"):
                r = stats[dom]
                print(f"{label}, {dom}: {len(r)} guided steps; "
                      f"std(x_t - sqrt(a)·x0) / std(x_t) smallest "
                      f"{min(c for c, _ in r):.3e}, median "
                      f"{sorted(c for c, _ in r)[len(r) // 2]:.3e}; "
                      f"std_normalize(condition noise) f32 - f64 largest "
                      f"{max(e for _, e in r):.3e}", flush=True)
    finally:
        diffusion.noise_like = zero
        GaussianDiffusion.p_mean_variance_condition = plain
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package's fused OS-SART drifting from the phantom (CPU, 64²).

``sart_fast_convert``'s default sweep (``fused=True``: the Kf = 1 grid,
each drive's subsets in turn) at the Mayo preset's 40 ordered subsets
(the plan takes 36, the largest count that divides the 180 folded
views), on two random-ellipse phantoms projected by the package's
``project_fast`` (64² grid, 360 views of 128 detectors: the small
geometry of the port's CPU tests): the PSNR against each phantom (crop 4
pixels a side, the range of the phantom over the RMS, as
tests/test_sart_fast.py scores) after 1-10 sweeps.

The port's fused sweep is the package's to its parity rule
(tests/test_torch_sart_fast.py, tests/test_torch_sart_unfolded.py), so
this is the reference for the fall that chip_smoke.py's ``unfused:``
phase prints at full width.

Run: python scripts/probe_sart_drift.py (the JAX package on the CPU,
about a minute).
"""
import os
import os.path as osp
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ipdm_tpu.recon.fbp import FBPGeometry  # noqa: E402
from ipdm_tpu.recon.phantom import random_ellipse_phantom  # noqa: E402
from ipdm_tpu.recon.sart_fast import (project_fast,  # noqa: E402
                                      sart_fast_convert)

SMALL = dict(n_det=128, n_views=360, grid_n=64, grid_l=21.0,
             da=0.0010125 * 912 / 128, det_offset=3.75, view_step_deg=1.0)


def psnr(ref, img, c=4):
    ref, img = ref[c:-c, c:-c], img[c:-c, c:-c]
    rng = max(float(ref.max() - ref.min()), 1e-9)
    return float(10 * np.log10(rng ** 2 / np.mean((ref - img) ** 2)))


def main():
    g = FBPGeometry(**SMALL)
    vol = np.stack([random_ellipse_phantom(64, np.random.default_rng(i))
                    for i in range(2)]).astype(np.float32)
    pj = project_fast(jnp.asarray(vol), g, g.N, float(g.nda[0]),
                      float(g.da))
    print("PSNR (dB) of the fused convert against 2 random-ellipse "
          "phantoms, 64², 40 subsets, folded")
    for ns in (1, 2, 3, 4, 6, 8, 10):
        t0 = time.perf_counter()
        out = np.asarray(sart_fast_convert(pj, g, nstart=ns, nsubsets=40))
        print(f"{ns:3d} sweeps: "
              f"{[round(psnr(v.T, x), 3) for v, x in zip(vol, out)]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()

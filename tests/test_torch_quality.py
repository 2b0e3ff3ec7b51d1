"""The port's denoising-quality contract: a trained port model must
IMPROVE its input. The twin of tests/test_quality.py for
``ipdm_tpu_torch``.

It runs examples/synthetic_e2e_torch.py on the CPU at the JAX contract's
settings (a 16-slice random-ellipse corpus at 64², 200 iterations of
training per domain, the progressive test on 4 slices with the FBP
convertor) and asserts test_quality.py's two inequalities: deProg beats
the LDCT PSNR by more than 1 dB, and the projection-domain stage alone
loses less than 3 dB. ``scripts/jax_quality_reading.py`` gives the JAX
package's reading at these settings (the 25.87 → 30.89 dB that
test_quality.py's docstring quotes is docs/PERF.md's 512², full-width
TPU demonstration, not a reading at these settings).
``chip_smoke.py``'s ``quality:`` phase runs the same contract on the
card, and the full-width demonstration's settings beside it.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))


@pytest.mark.slow
def test_trained_progressive_improves_psnr(tmp_path):
    from synthetic_e2e_torch import main

    ldct, deproj, deprog, _ = main([
        "--device", "cpu", "--out", str(tmp_path / "synth"), "--n", "16",
        "--size", "64", "--iters", "200", "--test-slices", "4",
    ])
    assert deprog > ldct + 1.0, (
        f"trained progressive denoiser must beat its LDCT input by >1 dB: "
        f"LDCT {ldct:.2f} dB -> deProg {deprog:.2f} dB")
    # the projection-domain stage alone must also not destroy the image
    assert deproj > ldct - 3.0

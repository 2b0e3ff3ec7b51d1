"""The port's per-pixel λ building blocks against the JAX package's:
LambdaCurve (ipdm_tpu/ops/lambda_curve.py), condition_lambda_map,
nearest_upsample and avg_pool (ipdm_tpu/ops/lambda_map.py), miu2pixel
(ipdm_tpu/data/units.py) and the probe's residual map _compute_delt with
the lower median _torch_median (ipdm_tpu/diffusion/guided.py:42-69).
The JAX functions take NHWC, the port's NCHW; inputs come from numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.data.units import miu2pixel as jax_miu2pixel
from ipdm_tpu.diffusion.guided import _compute_delt as jax_compute_delt
from ipdm_tpu.diffusion.guided import _torch_median as jax_median
from ipdm_tpu.ops import lambda_curve as jax_curve
from ipdm_tpu.ops import lambda_map as jax_map
from ipdm_tpu_torch.data.units import miu2pixel
from ipdm_tpu_torch.diffusion.guided import _compute_delt, _torch_median
from ipdm_tpu_torch.ops import lambda_curve, lambda_map


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("domain", ["img", "proj"])
def test_lambda_curve_matches_jax(domain):
    init = "curve_init" if domain == "img" else "proj_curve_init"
    # below the clamp, both pieces, the knot at 1.7, above the clamp
    x = np.concatenate([np.random.default_rng(0).uniform(0.5, 3.5, 500),
                        [1.0, 1.7, 2.75]]).astype(np.float32)
    want = np.asarray(getattr(jax_curve, init)()(jnp.asarray(x)))
    got = getattr(lambda_curve, init)()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    # the same f32 Horner steps in the same order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i", [0, 7, 14])
def test_condition_lambda_map_matches_jax(i):
    delt = np.random.default_rng(i).uniform(0.05, 20.0, (2, 5, 6, 1))
    delt = delt.astype(np.float32)
    want = np.asarray(jax_map.condition_lambda_map(jnp.asarray(delt),
                                                   jnp.int32(i), 15))
    got = lambda_map.condition_lambda_map(nchw(delt), i, 15)
    # one f32 power per pixel of an f32 ratio
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-6)
    assert got.min() >= np.float32(0.05) and got.max() <= np.float32(0.99)


@pytest.mark.parametrize("size", [(20, 24), (13, 17)])
def test_nearest_upsample_matches_jax(size):
    """An exact multiple (a repeat) and not (floor indices): exact."""
    x = np.random.default_rng(1).random((2, 5, 6, 1)).astype(np.float32)
    want = np.asarray(jax_map.nearest_upsample(jnp.asarray(x), size))
    got = lambda_map.nearest_upsample(nchw(x), size)
    np.testing.assert_array_equal(nhwc(got), want)


def test_avg_pool_drops_the_remainder_like_jax():
    x = np.random.default_rng(2).random((2, 18, 21, 1)).astype(np.float32)
    want = np.asarray(jax_map.avg_pool(jnp.asarray(x), 4))
    got = lambda_map.avg_pool(nchw(x), 4)
    assert tuple(got.shape) == (2, 1, 4, 5)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-7)


def test_miu2pixel_matches_jax():
    miu = np.random.default_rng(3).uniform(-0.1, 0.9, (1000,))
    miu = miu.astype(np.float32)
    want = np.asarray(jax_miu2pixel(jnp.asarray(miu)))
    got = miu2pixel(torch.from_numpy(miu))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_torch_median_is_the_lower_median():
    x = np.random.default_rng(4).permutation(10).astype(np.float32)
    assert float(_torch_median(torch.from_numpy(x))) == 4.0
    assert float(jax_median(jnp.asarray(x))) == 4.0


@pytest.mark.parametrize("mode,amplitude,curve", [
    ("img", 30.0, "curve_init"), ("proj", 7.0, "proj_curve_init")])
def test_compute_delt_matches_jax(mode, amplitude, curve):
    """Both orders (img: pool then median, through miu2pixel; proj: median
    then pool, with the max), on an even element count (2·16·20), where
    the lower median and numpy's mean-of-two differ."""
    rng = np.random.default_rng(5)
    scale = 0.3 if mode == "img" else 0.05
    x_in = rng.random((2, 16, 20, 1)).astype(np.float32)
    x_out = (x_in + scale * rng.standard_normal(x_in.shape)).astype(
        np.float32)
    want, want_max = jax_compute_delt(
        jnp.asarray(x_out), jnp.asarray(x_in), mode, 4, amplitude,
        getattr(jax_curve, curve)())
    got, got_max = _compute_delt(nchw(x_out), nchw(x_in), mode, 4,
                                 amplitude, getattr(lambda_curve, curve)())
    assert tuple(got.shape) == (2, 1, 4, 5)
    # exp of an f32 residual, then the curve: relative to the map's range
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    if mode == "img":
        assert got_max is None and want_max is None
    else:
        np.testing.assert_allclose(float(got_max), float(want_max),
                                   rtol=1e-5)

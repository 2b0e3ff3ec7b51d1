"""The port's planar_unit (plain PyTorch version) against the JAX Pallas
kernel ipdm_tpu/ops/pallas/planar.py:planar_unit in interpret mode, at the
shapes of tests/test_planar_fused.py. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.ops.pallas.planar import planar_unit as jax_planar_unit
from ipdm_tpu_torch.ops.cuda import _build
from ipdm_tpu_torch.ops.cuda.planar import planar_unit, planar_unit_plain


def _inputs(seed, B, C, O, H, W, with_skip):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, C, H, W)).astype(np.float32)
    a = rng.normal(1, 0.2, (B, C)).astype(np.float32)
    bb = rng.normal(0, 0.2, (B, C)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, C, O)).astype(np.float32)
    bias = rng.normal(0, 0.2, (B, O)).astype(np.float32)
    skip = (rng.normal(0, 1, (B, O, H, W)).astype(np.float32)
            if with_skip else None)
    return x, a, bb, w, bias, skip


def _both(inputs, act, v2, ht, dtype=np.float32):
    x, a, bb, w, bias, skip = inputs
    jx = jnp.asarray(x).astype(dtype)
    jskip = None if skip is None else jnp.asarray(skip).astype(dtype)
    want = np.asarray(jax_planar_unit(
        jx, jnp.asarray(a), jnp.asarray(bb), jnp.asarray(w),
        jnp.asarray(bias), jskip, act=act, ht=ht, interpret=True,
        v2=v2).astype(jnp.float32))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    t = lambda arr: torch.from_numpy(arr)
    got = planar_unit_plain(
        t(x).to(tdt), t(a), t(bb), t(w), t(bias),
        None if skip is None else t(skip).to(tdt), act=act)
    assert got.dtype == tdt
    return got.float().numpy(), want


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("act,with_skip,ht", [(True, True, 16),
                                              (True, False, 8),
                                              (False, False, 16)])
def test_planar_plain_matches_pallas(act, with_skip, ht, v2):
    inputs = _inputs(0, 2, 3, 5, 37, 150, with_skip)
    got, want = _both(inputs, act, v2, ht)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v2", [False, True])
def test_planar_plain_matches_pallas_lane_multiple_width(v2):
    """W = 128: the conv's zero padding at the image edge is zero after
    the activation, not act(bb)."""
    inputs = _inputs(7, 1, 4, 4, 24, 128, False)
    got, want = _both(inputs, True, v2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_planar_plain_matches_pallas_bf16():
    """bf16 x and skip, C = 16 (the proj UNet's 16-channel level): the TPU
    v2 body splits C into two 8-channel chunks and rounds once to bf16
    between them; the port sums all of C in f32 and rounds once. So the
    two differ by at most about two bf16 roundings of the output:
    |diff| <= 2·2^-8·|out| + 2e-2 (outputs are O(10))."""
    inputs = _inputs(3, 1, 16, 8, 20, 40, True)
    got, want = _both(inputs, True, True, 8, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -8, atol=2e-2)


def test_planar_wrapper_takes_plain_version_on_cpu():
    x, a, bb, w, bias, skip = (None if v is None else torch.from_numpy(v)
                               for v in _inputs(1, 1, 2, 3, 9, 11, True))
    before = _build.LAUNCHES["planar_unit"]
    got = planar_unit(x, a, bb, w, bias, skip)
    torch.testing.assert_close(got, planar_unit_plain(x, a, bb, w, bias,
                                                      skip), rtol=0, atol=0)
    assert _build.LAUNCHES["planar_unit"] == before

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
from ipdm_tpu_torch.ops.cuda.planar import (MAX_CO, planar_unit,
                                           planar_unit_plain)


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


# the units the proj UNet at the Mayo preset's widths sends to planar_unit,
# per eval: (C, O, act, skip, downsampling factor) -> count
MAYO_PROJ_UNITS = {(1, 4, False, False, 1): 1,     # stem
                   (4, 8, True, False, 1): 1,
                   (8, 8, True, True, 1): 5,
                   (8, 8, True, False, 1): 1,
                   (16, 8, True, False, 1): 1,
                   (12, 8, True, False, 1): 1,
                   (8, 16, True, False, 2): 1,
                   (8, 1, True, False, 1): 1}      # output conv


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("C,O,act,with_skip",
                         sorted({k[:4] for k in MAYO_PROJ_UNITS}))
def test_planar_plain_matches_pallas_main_path_units(C, O, act, with_skip,
                                                     dtype):
    """Each unit of the proj UNet's main path at a small ragged 13×37
    plane, against the TPU kernel's _unit_kernel body in interpret mode
    (the v2 body is held above; its unrolled C·O·9 multiply-adds take
    ~10 s each to interpret). Both sum all of C in f32 and round once, so
    bf16 outputs agree to one bf16 rounding: 2⁻⁸·|out| + 1e-2."""
    inputs = _inputs(C * 31 + O, 1, C, O, 13, 37, with_skip)
    got, want = _both(inputs, act, False, 8, dtype=dtype)
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-2)


def test_mayo_proj_unet_planar_units():
    """UNetModel.plan() at the proj widths of
    Config/Mayo-Config/test_progressive_option.json, driven once at a small
    plane: the (C, O) pairs conv_unit sends to planar_unit are the table
    above (12 units per eval, every C·O ≤ MAX_CO), and the img UNet (64+
    channels) sends none."""
    import json
    import os
    from collections import Counter

    from ipdm_tpu_torch.models import unet

    path = os.path.join(os.path.dirname(__file__), os.pardir, "Config",
                        "Mayo-Config", "test_progressive_option.json")
    with open(path) as f:
        cfg = json.load(f)
    calls = []

    def record(x, a, bb, w, bias, skip=None, act=True):
        calls.append((x.shape[1], w.shape[3], act, skip is not None,
                      -(-125 // x.shape[2])))
        return planar_unit_plain(x, a, bb, w, bias, skip, act=act)

    seen = {}
    for domain in ("proj", "img"):
        torch.manual_seed(0)
        m = unet.UNetModel(
            in_channels=1, out_channels=1,
            model_channels=cfg[f"model_channels_{domain}"],
            attention_resolutions=tuple(cfg[f"attention_resolutions_{domain}"]),
            channel_mult=tuple(cfg[f"channel_mult_{domain}"]), device="cpu")
        down, _, up, _ = m.plan()
        assert down[0] == ("stem", 4 if domain == "proj" else 64)
        calls.clear()
        orig = unet.planar_unit
        unet.planar_unit = record
        try:
            with torch.no_grad():
                m(torch.rand(1, 1, 125, 57 if domain == "proj" else 64),
                  torch.tensor([3]))
        finally:
            unet.planar_unit = orig
        seen[domain] = Counter(calls)
    assert dict(seen["proj"]) == MAYO_PROJ_UNITS
    assert sum(seen["proj"].values()) == 12
    assert all(c * o <= MAX_CO for c, o, *_ in seen["proj"])
    assert not seen["img"]

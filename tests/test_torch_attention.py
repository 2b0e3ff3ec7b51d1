"""The port's AttentionBlock (plain path on the CPU) against the Flax
AttentionBlock of ipdm_tpu/models/unet.py, in f32, with the Flax weights
carried across. Off the TPU the Flax block computes the einsum formula of
unet.py:659-662; at >= FLASH_MIN_SEQ tokens the port's block routes to
flash_attention, whose CPU branch is that same formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.models.unet import AttentionBlock as FlaxAttention
from ipdm_tpu_torch.models.unet import AttentionBlock
from ipdm_tpu_torch.ops.cuda import _build
from ipdm_tpu_torch.ops.cuda.attention import FLASH_MIN_SEQ


def _run_both(C, heads, H, W, seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    fl = FlaxAttention(C, heads)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape,
        fl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    want = np.asarray(fl.apply({"params": params}, jnp.asarray(x)))

    blk = AttentionBlock(C, heads, device="cpu")
    conv = lambda k: torch.from_numpy(np.ascontiguousarray(
        k.transpose(3, 2, 0, 1)))
    blk.load_state_dict({
        "norm.weight": torch.from_numpy(params["GN_0"]["scale"]),
        "norm.bias": torch.from_numpy(params["GN_0"]["bias"]),
        "qkv.weight": conv(params["qkv"]["kernel"]),
        "proj.weight": conv(params["proj"]["kernel"]),
        "proj.bias": torch.from_numpy(params["proj"]["bias"])})
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


@pytest.mark.parametrize("C,heads,H,W", [(16, 2, 6, 7), (24, 4, 5, 3)])
def test_attention_block_matches_flax(C, heads, H, W):
    got, want = _run_both(C, heads, H, W, seed=C)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_attention_block_long_sequence_routes_to_flash_wrapper():
    """64×64 = 4096 tokens take the flash route; on a CPU tensor that is
    the plain formula, and no kernel launch is counted."""
    assert 64 * 64 >= FLASH_MIN_SEQ
    before = _build.LAUNCHES["flash_attn"]
    got, want = _run_both(8, 1, 64, 64, seed=5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert _build.LAUNCHES["flash_attn"] == before


def test_attention_block_ragged_long_sequence_head_dim_64():
    """65×65 = 4225 tokens at head dimension 64 (C=64, one head, B=1): the
    flash route at a token count that leaves a ragged last key tile of the
    kernel (4225 = 66·64 + 1); on a CPU tensor the plain formula, no
    launch counted."""
    assert 65 * 65 >= FLASH_MIN_SEQ and (65 * 65) % 64
    before = _build.LAUNCHES["flash_attn"]
    got, want = _run_both(64, 1, 65, 65, seed=11, B=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert _build.LAUNCHES["flash_attn"] == before

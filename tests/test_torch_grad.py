"""Gradients through the port's kernel wrappers (planar_unit,
flash_attention) against jax.grad of the Flax modules of
ipdm_tpu/models/unet.py, on the CPU: there each wrapper's
autograd.Function runs the plain forward and recomputes it for the
backward, as it recomputes the plain version behind the kernel on the
card. Same seeded numpy inputs, weights and output cotangent on both
sides; the Flax weights and the JAX gradient tree come across through
the port's state_dict_from_flax. The card's gradients (kernel forward)
are held against the CPU's by chip_smoke.py's grad phase."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.models.unet import AttentionBlock as FlaxAttention
from ipdm_tpu.models.unet import UNetModel as FlaxUNet
from ipdm_tpu_torch.models.unet import AttentionBlock, UNetModel
from ipdm_tpu_torch.ops.cuda import _build, attention, planar
from ipdm_tpu_torch.ops.cuda.attention import FLASH_MIN_SEQ
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax

# small configs: img-like (no level narrow enough for the planar
# layout, as the img UNet), and proj-like whose first two levels (2 and 4
# channels) run conv_unit's planar branch. The Flax UNet's planar levels
# unroll per channel off the TPU, so they are kept narrow: compiling the
# gradient of a 4/8/16-channel planar stack takes minutes on the CPU
IMG_LIKE = dict(in_channels=1, model_channels=40, out_channels=1,
                num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), num_heads=2)
PROJ_LIKE = dict(in_channels=1, model_channels=8, out_channels=1,
                 num_res_blocks=1, attention_resolutions=(2,),
                 channel_mult=(0.25, 0.5, 8), num_heads=2)


def _flax_unet(cfg, seed):
    model = FlaxUNet(**cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 12, 10, cfg["in_channels"])),
                            jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.08, a.shape).astype(np.float32),
        shapes["params"])
    return model, {"params": params}


def _graph_has(out, node: str) -> bool:
    """Whether the autograd graph behind ``out`` holds a ``node`` node."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == node:
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


def _close(got, want, name, scale=0.0):
    """f32 gradients of a few hundred terms per entry summed in another
    order: 1e-4 of the tensor's largest entry plus 1e-3 of each, plus
    1e-5 of ``scale`` (the model's largest gradient entry): an entry whose
    exact value is zero, such as the bias of a conv whose output a
    one-channel GroupNorm group re-centres, carries the rounding of the
    terms that cancel in it, which scale with the model's gradients."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-4 * np.abs(want).max() + 1e-3 * np.abs(want) + 1e-5 * scale
    assert np.all(np.abs(got - want) <= tol), (
        name, float(np.abs(got - want).max()), float(np.abs(want).max()))


@pytest.mark.parametrize("cfg", [IMG_LIKE, PROJ_LIKE],
                         ids=["img-like", "proj-like-planar"])
def test_unet_gradients_match_jax_grad(cfg):
    fmodel, fparams = _flax_unet(cfg, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 13, 11, cfg["in_channels"])).astype(np.float32)
    t = np.array([5, 30], np.int32)
    cot = rng.normal(0, 1, (2, 13, 11, cfg["out_channels"])
                     ).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(fmodel.apply(p, xx, jnp.asarray(t)) * cot)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(fparams,
                                                    jnp.asarray(x))

    model = UNetModel(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, fparams))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = model(xt, torch.from_numpy(t.astype(np.int64)))
    assert _graph_has(out, "_PlanarUnitBackward") == (cfg is PROJ_LIKE)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    want = state_dict_from_flax(model, {"params": jax.tree_util.tree_map(
        np.asarray, gp["params"])})
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close(p.grad.numpy(), want[name].numpy(), name, scale)
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), "x")


def test_attention_block_long_sequence_gradients_match_jax_grad():
    """64×64 = 4096 tokens at head dimension 64 (C=64, one head): the
    port's block takes the flash wrapper's Function, the Flax block (off
    the TPU) its einsum path."""
    C, H, W = 64, 64, 64
    assert H * W >= FLASH_MIN_SEQ
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (1, H, W, C)).astype(np.float32)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    fl = FlaxAttention(C, 1)
    shapes = jax.eval_shape(fl.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32),
        shapes["params"])
    gp, gx = jax.grad(lambda p, xx: jnp.sum(
        fl.apply({"params": p}, xx) * cot), argnums=(0, 1))(
        params, jnp.asarray(x))

    blk = AttentionBlock(C, 1, device="cpu")
    conv = lambda k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(k).transpose(3, 2, 0, 1)))
    to_sd = lambda p: {
        "norm.weight": torch.from_numpy(np.asarray(p["GN_0"]["scale"])),
        "norm.bias": torch.from_numpy(np.asarray(p["GN_0"]["bias"])),
        "qkv.weight": conv(p["qkv"]["kernel"]),
        "proj.weight": conv(p["proj"]["kernel"]),
        "proj.bias": torch.from_numpy(np.asarray(p["proj"]["bias"]))}
    blk.load_state_dict(to_sd(params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    before = _build.LAUNCHES["flash_attn"]
    out = blk(xt)
    assert _graph_has(out, "_FlashAttentionBackward")
    assert _build.LAUNCHES["flash_attn"] == before
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    want = to_sd(gp)
    for name, p in blk.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name)
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), "x")


def _planar_inputs(seed, dtype=torch.float32, skip=True):
    g = torch.Generator().manual_seed(seed)
    B, C, O, H, W = 2, 4, 8, 9, 7
    r = lambda *s: torch.randn(*s, generator=g)
    ins = [r(B, C, H, W).to(dtype), r(B, C), r(B, C), r(3, 3, C, O) * 0.3,
           r(B, O), r(B, O, H, W).to(dtype) if skip else None]
    return [None if t is None else t.requires_grad_() for t in ins]


def _attention_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(2, 40, 64, generator=g).requires_grad_()
            for _ in range(3)]


@pytest.mark.parametrize("kernel", ["planar", "planar-bf16-noskip",
                                    "flash"])
def test_function_gradients_equal_plain_autograd(kernel):
    """On the CPU the Function's forward is the plain version and its
    backward recomputes it: the gradients are plain autograd's, bit for
    bit, for every input."""
    if kernel == "flash":
        ins = _attention_inputs(1)
        via = attention.flash_attention(*ins, 0.35)
        plain = attention.attention_plain(*ins, 0.35)
        name = "_FlashAttentionBackward"
    else:
        bf16 = kernel != "planar"
        ins = _planar_inputs(2, torch.bfloat16 if bf16 else torch.float32,
                             skip=not bf16)
        via = planar.planar_unit(*ins, act=True)
        plain = planar.planar_unit_plain(*ins, act=True)
        name = "_PlanarUnitBackward"
    assert type(via.grad_fn).__name__ == name
    live = [t for t in ins if t is not None]
    g = torch.randn(via.shape, generator=torch.Generator().manual_seed(3)
                    ).to(via.dtype)
    for a, b in zip(torch.autograd.grad(via, live, g),
                    torch.autograd.grad(plain, live, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_function_only_where_a_gradient_is_needed():
    """Under no_grad (the sampler's path) and on inputs that need no
    gradient the wrapper saves nothing and builds no graph; with grad the
    Function saves its inputs once."""
    saved = []

    def pack(t):
        saved.append(t.shape)
        return t

    ins = _planar_inputs(5)
    qkv = _attention_inputs(6)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            assert planar.planar_unit(*ins).grad_fn is None
            assert attention.flash_attention(*qkv, 0.35).grad_fn is None
        frozen = [t.detach() for t in ins]
        assert planar.planar_unit(*frozen).grad_fn is None
        assert not saved
        planar.planar_unit(*ins)
        assert len(saved) == 6
        attention.flash_attention(*qkv, 0.35)
        assert len(saved) == 9

"""The port's UNetModel against the Flax UNetModel of
ipdm_tpu/models/unet.py, with the Flax weights carried across by the
port's state_dict_from_flax (the configs of tests/test_torch_import.py,
f32, odd input size), and the port's kernel routing at the bench.py
widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu.models.unet import UNetModel as FlaxUNet
from ipdm_tpu.utils.torch_import import export_state_dict
from ipdm_tpu_torch.models import unet as port_unet
from ipdm_tpu_torch.models.unet import UNetModel, build_unet
from ipdm_tpu_torch.utils.torch_import import (state_dict_from_flax,
                                               strip_module_prefix)

IMG_LIKE = dict(in_channels=1, model_channels=16, out_channels=1,
                num_res_blocks=2, attention_resolutions=(2,),
                channel_mult=(1, 1, 2), num_heads=4)
PROJ_LIKE = dict(in_channels=1, model_channels=16, out_channels=1,
                 num_res_blocks=1, attention_resolutions=(2, 4),
                 channel_mult=(0.25, 0.5, 1, 2), num_heads=2)


def _random_flax(cfg, seed):
    """A Flax UNet and random params (every leaf N(0, 0.08), as
    tests/test_torch_import.py draws them)."""
    model = FlaxUNet(**cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 24, 20, cfg["in_channels"])),
                            jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.08, a.shape).astype(np.float32),
        shapes["params"])
    return model, {"params": params}


@pytest.mark.parametrize("cfg", [IMG_LIKE, PROJ_LIKE],
                         ids=["img-like", "proj-like-fractional"])
def test_unet_matches_flax(cfg):
    fmodel, fparams = _random_flax(cfg, seed=0)
    x = np.random.default_rng(1).normal(
        0, 1, (2, 25, 22, cfg["in_channels"])).astype(np.float32)
    t = np.array([3, 40], np.int64)
    want = np.asarray(jax.jit(fmodel.apply)(fparams, jnp.asarray(x),
                                            jnp.asarray(t.astype(np.int32))))

    model = UNetModel(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, fparams))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("cfg", [IMG_LIKE, PROJ_LIKE],
                         ids=["img-like", "proj-like-fractional"])
def test_state_dict_keys_match_reference_export(cfg):
    """The port's state_dict has the original repo's keys and shapes: the
    ones ipdm_tpu.utils.torch_import.export_state_dict emits."""
    fmodel, fparams = _random_flax(cfg, seed=2)
    ref = export_state_dict(fmodel, fparams)
    model = UNetModel(**cfg, device="cpu")
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
    ddp = {f"module.{k}": torch.from_numpy(v) for k, v in ref.items()}
    model.load_state_dict(strip_module_prefix(ddp))


def _bench_opt(domain):
    # bench.py:135-142 widths
    if domain == "proj":
        return dict(in_channels_proj=1, out_channels_proj=1,
                    model_channels_proj=64,
                    attention_resolutions_proj=[16, 32],
                    channel_mult_proj=[0.0625, 0.125, 0.25, 2, 2, 4, 4],
                    compute_dtype="bfloat16")
    return dict(in_channels_img=1, out_channels_img=1, model_channels_img=64,
                attention_resolutions_img=[8, 16],
                channel_mult_img=[1, 1, 2, 2, 4, 4], compute_dtype="bfloat16")


@pytest.mark.parametrize("domain,units", [("proj", 12), ("img", 0)])
def test_bench_unet_kernel_routing(monkeypatch, domain, units):
    """At the bench.py widths the proj UNet sends 12 GN→SiLU→conv units
    per eval to planar_unit (the units the JAX package sends to its Pallas
    kernel on a TPU: planar blocks, stride 1, C·O <= 160) and the img UNet
    none; small inputs keep attention below FLASH_MIN_SEQ."""
    calls = {"planar": [], "flash": 0}
    real_unit = port_unet.planar_unit

    def count_unit(x, a, bb, w, bias, skip=None, act=True):
        calls["planar"].append((x.shape[1], w.shape[3], act,
                                skip is not None))
        return real_unit(x, a, bb, w, bias, skip, act=act)

    def count_flash(*args):
        calls["flash"] += 1

    monkeypatch.setattr(port_unet, "planar_unit", count_unit)
    monkeypatch.setattr(port_unet, "flash_attention", count_flash)
    torch.manual_seed(0)
    model = build_unet(_bench_opt(domain), domain, device="cpu")
    with torch.no_grad():
        y = model(torch.rand(1, 1, 64, 32), torch.tensor([5]))
    assert y.shape == (1, 1, 64, 32) and y.dtype == torch.float32
    assert len(calls["planar"]) == units
    assert all(c * o <= 160 for c, o, _, _ in calls["planar"])
    assert calls["flash"] == 0
    if domain == "proj":
        # the stem runs without the activation (the up path's upsample
        # convs are 16x16 = 256 > 160); the five residual blocks whose
        # second unit is routed add their shortcut there
        assert sum(not act for _, _, act, _ in calls["planar"]) == 1
        assert sum(s for _, _, _, s in calls["planar"]) == 5
